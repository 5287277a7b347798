"""Parallel training over ``torch.distributed`` (one process per GPU):
data parallelism (``dp``, ``distributed_trainer``; each node's assembler
hands the node's other ranks their minibatches through ``handoff``), edge
sharding (``edge_sharding``), node sharding (``node_sharding``) and the
node-sharded trainer (``node_sharded_trainer``)."""
from ptgnn_tpu_torch.parallel.distributed_trainer import DistributedModelTrainer, initialize_multi_host
from ptgnn_tpu_torch.parallel.dp import LOCAL, DataParallel, moment_elements, zero1_optimizer
from ptgnn_tpu_torch.parallel.edge_sharding import EdgeParallel, shard_adjacency, sharded_aggregate
from ptgnn_tpu_torch.parallel.node_sharded_trainer import NodeShardedModelTrainer, node_data_groups
from ptgnn_tpu_torch.parallel.node_sharding import (
    BoundaryBudgetError,
    NodeParallel,
    shard_batch_by_nodes,
    suggest_budgets,
)

__all__ = [
    "BoundaryBudgetError",
    "DataParallel",
    "DistributedModelTrainer",
    "EdgeParallel",
    "LOCAL",
    "NodeParallel",
    "NodeShardedModelTrainer",
    "initialize_multi_host",
    "moment_elements",
    "node_data_groups",
    "shard_adjacency",
    "shard_batch_by_nodes",
    "sharded_aggregate",
    "suggest_budgets",
    "zero1_optimizer",
]
