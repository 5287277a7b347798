"""``prefetch_to_device`` (``ptgnn_tpu_torch/core/trainer.py``), the
counterpart of the JAX trainer's ``_prefetch_device_batches``: the items
pass through in order with their minibatches on the device (a ``None``
minibatch stays ``None``); one epoch of ``ModelTrainer`` at prefetch 1, 2
and 3 ends on bitwise the same parameters, with dropout on; so do the
data-parallel trainer (whose ranks finalize only their own slot of each
group) and the node-sharded trainer on 2 gloo ranks."""
import numpy as np
import pytest
import torch

from ptgnn_tpu_torch.core.trainer import ModelTrainer, prefetch_to_device
from ptgnn_tpu_torch.implementations.typilus.harness import small_padding
from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs
from tests.torch_shard_worker import launch


@pytest.mark.parametrize("size", [1, 2, 5])
def test_items_pass_through_in_order_on_the_device(size):
    items = [({"x": np.full(3, i, np.float32)}, f"raw{i}", i) for i in range(4)] + [(None, "skipped", 4)]
    got = list(prefetch_to_device(iter(items), torch.device("cpu"), size))
    assert [rest for _, *rest in got] == [[f"raw{i}", i] for i in range(4)] + [["skipped", 4]]
    for i, (mb, *_) in enumerate(got[:4]):
        assert isinstance(mb["x"], torch.Tensor) and torch.equal(mb["x"], torch.full((3,), float(i)))
    assert got[4][0] is None


def test_a_size_below_one_raises():
    with pytest.raises(ValueError):
        list(prefetch_to_device(iter([]), torch.device("cpu"), 0))
    with pytest.raises(ValueError):
        ModelTrainer(create_graph2class_gnn_model(padding=small_padding()), "m.pkl.gz", prefetch_to_device=0,
                     device="cpu")


def _epoch(tmp_path, prefetch):
    model = create_graph2class_gnn_model(hidden_state_size=32, padding=small_padding(max_nodes=256, max_graphs=8),
                                         dropout_rate=0.1)
    trainer = ModelTrainer(model, tmp_path / f"g2c-{prefetch}.pkl.gz", max_num_epochs=1, minibatch_size=8,
                           prefetch_to_device=prefetch, device="cpu", seed=3)
    metrics = []
    trainer.register_train_epoch_end_hook(
        lambda m, mod, e, ms: metrics.append({k: v for k, v in ms.items() if k != "_throughput"}))
    data = list(synthetic_typilus_graphs(40, seed=1, mean_nodes=60, max_nodes=120))
    trainer.train(data, data[:8], parallelize=False, validate_on_start=False)
    return {k: v.detach().clone() for k, v in trainer.neural_module.named_parameters()}, metrics


def test_model_trainer_epoch_is_bitwise_the_same_at_any_prefetch(tmp_path):
    ref_params, ref_metrics = _epoch(tmp_path, 1)
    for prefetch in (2, 3):
        params, metrics = _epoch(tmp_path, prefetch)
        assert metrics == ref_metrics
        for k in ref_params:
            assert torch.equal(params[k], ref_params[k]), (prefetch, k)


def test_distributed_trainers_prefetch_on_two_ranks(tmp_path):
    ranks = launch([("trainer_prefetch", {})], tmp_path, world=2)
    for (out,) in ranks:
        for kind in ("data-parallel", "node-sharded"):
            one, two = out[(kind, 1)], out[(kind, 2)]
            assert one.keys() == two.keys()
            for k in one:
                assert torch.equal(one[k], two[k]), (kind, k)
