"""Ranks of the port's data-parallel tests (``test_torch_parallel_dp.py``):
each runs in a process of its own, joins a gloo group through a ``file://``
rendezvous and writes its results with ``torch.save``. This module imports
no JAX, so a spawned rank starts quickly.

The parent writes the case's inputs (the port's model and converted
weights, host minibatches, weights) with ``torch.save``; :func:`launch`
starts the ranks, joins each with a timeout, kills what is left and returns
their results."""
from __future__ import annotations

import multiprocessing
from pathlib import Path
from typing import Any, Dict, List

import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 240.0


def launch(case: str, payload: Dict[str, Any], tmp: Path, world: int = 2) -> List[Dict[str, Any]]:
    """Run ``case`` on ``world`` gloo ranks; returns each rank's results.
    A rank still running after the timeout is killed and the case fails."""
    tmp = Path(tmp)
    torch.save(payload, tmp / "payload.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(case, rank, world, str(tmp))) for rank in range(world)]
    for p in procs:
        p.start()
    hung = []
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                hung.append(p.pid)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if hung:
        raise TimeoutError(f"{case}: ranks {hung} were still running after {JOIN_TIMEOUT_S} s and were killed")
    codes = [p.exitcode for p in procs]
    if any(codes):
        errors = [(tmp / f"error{r}.txt").read_text() for r in range(world) if (tmp / f"error{r}.txt").exists()]
        raise RuntimeError(f"{case}: rank exit codes {codes}\n" + "\n".join(errors))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main(case: str, rank: int, world: int, tmp: str) -> None:
    import traceback

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world, rank=rank)
        try:
            payload = torch.load(Path(tmp) / "payload.pt", weights_only=False)
            out = CASES[case](payload, rank, world, Path(tmp))
        finally:
            dist.destroy_process_group()
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    except BaseException:
        (Path(tmp) / f"error{rank}.txt").write_text(traceback.format_exc())
        raise


def _module(payload):
    module = payload["model"].build_neural_module(device="cpu", seed=0)
    module.load_state_dict(payload["state"])
    return module


def _params(module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _batch(mb):
    from ptgnn_tpu_torch.graph.structs import tree_to

    return tree_to(mb, torch.device("cpu"))


def _sgd_step(payload, rank, world, tmp):
    """One weighted step (SGD 0.1): this rank's minibatch and weight."""
    from ptgnn_tpu_torch.parallel.dp import DataParallel

    module = _module(payload)
    optimizer = torch.optim.SGD(module.parameters(), lr=0.1)
    dp = DataParallel(module)
    loss, metrics = dp.train_step(_batch(payload["minibatches"][rank]), payload["weights"][rank],
                                  torch.Generator(), optimizer, [0.1])
    return {"params": _params(module), "loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "allreduce_calls": dp.allreduce_calls, "allreduce_bytes": dp.allreduce_bytes}


def _zero1(payload, rank, world, tmp):
    """Adam steps with and without ZeRO-1 on the same gradients: the
    moments this rank holds, and both runs' parameters."""
    from ptgnn_tpu_torch.parallel.dp import DataParallel, moment_elements, zero1_optimizer

    out = {}
    for name in ("zero1", "full"):
        module = _module(payload)

        def adam(params):
            return torch.optim.Adam(params, lr=1e-3)

        optimizer = zero1_optimizer(module.parameters(), adam) if name == "zero1" else adam(module.parameters())
        dp = DataParallel(module)
        for step in range(2):
            dp.train_step(_batch(payload["minibatches"][rank]), payload["weights"][rank], torch.Generator(),
                          optimizer, [1e-3], clip_gradient_norm=1.0)
        out[name] = {"params": _params(module), "moments": moment_elements(optimizer)}
    out["total"] = 2 * sum(p.numel() for p in module.parameters())
    return out


def _accumulate(payload, rank, world, tmp):
    """Two groups accumulated, then one SGD step."""
    from ptgnn_tpu_torch.parallel.dp import DataParallel

    module = _module(payload)
    optimizer = torch.optim.SGD(module.parameters(), lr=0.1)
    dp = DataParallel(module)
    for group, weights in enumerate(payload["weights"]):
        dp.grad_step(_batch(payload["minibatches"][group * world + rank]), weights[rank], torch.Generator())
    dp.apply_gradients(optimizer, [0.1])
    return {"params": _params(module)}


def _groups(payload, rank, world, tmp):
    """The trainer's groups over the payload's model and graphs (no
    shuffle), then two epochs of DistributedModelTrainer.train."""
    from ptgnn_tpu_torch.core.data import LazyDataIterable
    from ptgnn_tpu_torch.parallel.distributed_trainer import DistributedModelTrainer
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    model = payload["model"]
    trainer = DistributedModelTrainer(
        model, tmp / "g2c_dp.pkl.gz", zero1=True, max_num_epochs=2, minibatch_size=3,
        optimizer_creator=lambda p: torch.optim.Adam(p, lr=1e-3), clip_gradient_norm=1.0,
        target_validation_metric="Accuracy", target_validation_metric_higher_is_better=True, device="cpu",
    )
    groups = []
    for mb, raw, weight in trainer.group_minibatches(model.minibatch_iterator(
            model.tensorize_dataset(iter(payload["graphs"]), parallelize=False), max_minibatch_size=3,
            yield_partial_minibatches=False, parallelize=False, finalize_slot=(rank, world))):
        groups.append({"weight": weight, "num_raw": len(raw), "batch": mb})

    def data(n, seed):
        return LazyDataIterable(lambda: synthetic_typilus_graphs(n, seed=seed, mean_nodes=30, max_nodes=80))

    fresh = payload["fresh_model"]
    trainer = DistributedModelTrainer(
        fresh, tmp / "g2c_train.pkl.gz", zero1=True, max_num_epochs=2, minibatch_size=3,
        optimizer_creator=lambda p: torch.optim.Adam(p, lr=1e-3), clip_gradient_norm=1.0,
        target_validation_metric="Accuracy", target_validation_metric_higher_is_better=True, device="cpu",
    )
    epochs = []
    trainer.register_train_epoch_end_hook(lambda m, nn, epoch, metrics: epochs.append(metrics))
    trainer.train(data(40, 1), data(10, 2), validate_on_start=False, parallelize=False,
                  store_tensorized_data_in_memory=True)
    accuracy = fresh.report_accuracy(iter(data(10, 3)), trainer.neural_module, device="cpu")
    return {"groups": groups, "params": _params(trainer.neural_module), "accuracy": accuracy,
            "epochs": epochs, "checkpoint": (tmp / "g2c_train.pkl.gz").exists(),
            "optimizer_state": (tmp / "g2c_train.pkl.gz").with_suffix(".optimizerstate").exists()}


def _nodes(payload, rank, world, tmp):
    """Each rank a node of its own (``local_world_size`` 1) with its own
    graphs, rank 1 with fewer: the weights each rank's groups carry, then
    one epoch of training over them."""
    from ptgnn_tpu_torch.core.data import LazyDataIterable
    from ptgnn_tpu_torch.parallel.distributed_trainer import DistributedModelTrainer

    model = payload["model"]
    graphs = payload["graphs"][rank]
    trainer = DistributedModelTrainer(
        model, tmp / "nodes.pkl.gz", local_world_size=1, max_num_epochs=1, minibatch_size=3,
        optimizer_creator=lambda p: torch.optim.Adam(p, lr=1e-3), clip_gradient_norm=1.0, device="cpu",
    )
    weights = [weight for _, _, weight in trainer.group_minibatches(model.minibatch_iterator(
        model.tensorize_dataset(iter(graphs), parallelize=False), max_minibatch_size=3,
        yield_partial_minibatches=False, parallelize=False))]
    trainer.load_metadata_and_create_network(graphs, parallelize=False)
    data = LazyDataIterable(lambda: iter(graphs))
    trainer.train(data, data, validate_on_start=False, parallelize=False, initialize_metadata=False)
    return {"weights": weights, "params": _params(trainer.neural_module), "node_rank": trainer.node_rank}


def _world_one(payload, rank, world, tmp):
    """ModelTrainer, then DistributedModelTrainer on this one rank, each for
    two shuffled epochs from the same seed: the parameters of both."""
    from ptgnn_tpu_torch.core.data import LazyDataIterable
    from ptgnn_tpu_torch.core.trainer import ModelTrainer
    from ptgnn_tpu_torch.parallel.distributed_trainer import DistributedModelTrainer

    data = LazyDataIterable(lambda: iter(payload["graphs"]))
    out = {}
    for name, trainer_class, extra in (("single", ModelTrainer, {}), ("ranked", DistributedModelTrainer, {"zero1": True})):
        trainer = trainer_class(
            payload[name], tmp / f"{name}.pkl.gz", max_num_epochs=2, minibatch_size=3, seed=5,
            optimizer_creator=lambda p: torch.optim.Adam(p, lr=1e-3), clip_gradient_norm=1.0, device="cpu", **extra,
        )
        trainer.train(data, data, validate_on_start=False, parallelize=False, shuffle_training_data=True)
        out[name] = _params(trainer.neural_module)
    return out


CASES = {"world_one": _world_one, "sgd_step": _sgd_step, "zero1": _zero1, "accumulate": _accumulate, "groups": _groups, "nodes": _nodes}
