"""Parallel training. This package has data parallelism over
``torch.distributed`` (one process per GPU); edge and node sharding and the
node-sharded trainer are not ported yet."""
from ptgnn_tpu_torch.parallel.distributed_trainer import DistributedModelTrainer, initialize_multi_host
from ptgnn_tpu_torch.parallel.dp import DataParallel, moment_elements, zero1_optimizer

__all__ = [
    "DataParallel",
    "DistributedModelTrainer",
    "initialize_multi_host",
    "moment_elements",
    "zero1_optimizer",
]
