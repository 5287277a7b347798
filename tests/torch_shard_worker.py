"""Ranks of the port's sharding tests (``test_torch_edge_sharding.py``,
``test_torch_node_sharding.py``, ``test_torch_node_sharded_trainer.py``).

A test module starts ONE world of gloo ranks (:func:`launch`) and hands it
every case of the module; each rank runs the cases in order and writes its
results with ``torch.save``. The parent computes the JAX references and
asserts. This module imports no JAX, so a spawned rank starts quickly.
Every rank is joined with a timeout; what is left is killed."""
from __future__ import annotations

import logging
import multiprocessing
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 280.0


def launch(cases: List[Tuple[str, Dict[str, Any]]], tmp: Path, world: int = 4) -> List[List[Any]]:
    """Run ``cases`` ((name, payload) pairs) in one world of ``world`` gloo
    ranks; returns each rank's list of case results."""
    tmp = Path(tmp)
    torch.save(cases, tmp / "cases.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, world, str(tmp))) for rank in range(world)]
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
    errors = [(tmp / f"error{r}.txt").read_text() for r in range(world) if (tmp / f"error{r}.txt").exists()]
    if hung:
        raise TimeoutError(f"ranks {hung} were still running after {JOIN_TIMEOUT_S} s and were killed\n"
                           + "\n".join(errors))
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}\n" + "\n".join(errors))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world, rank=rank)
        try:
            cases = torch.load(Path(tmp) / "cases.pt", weights_only=False)
            out = []
            for name, payload in cases:
                torch.manual_seed(0)
                out.append(CASES[name](payload, rank, world, Path(tmp)))
                dist.barrier()
        finally:
            dist.destroy_process_group()
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    except BaseException:
        (Path(tmp) / f"error{rank}.txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _module(payload):
    module = payload["model"].build_neural_module(device="cpu", seed=0)
    module.load_state_dict(payload["state"])
    return module


def _params(module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _to(tree):
    from ptgnn_tpu_torch.graph.structs import tree_to

    return tree_to(tree, torch.device("cpu"))


def _pair_groups(world: int):
    """Node groups of two consecutive ranks; every rank creates all."""
    return [dist.new_group([g, g + 1]) for g in range(0, world, 2)]


class SumOfSquaresHead(torch.nn.Module):
    """A loss over a bare GNN for the node-sharded tests: the mean over the
    real nodes of the squared output states, through the whole node table
    (one all-gather under node sharding)."""

    def __init__(self, gnn):
        super().__init__()
        self.gnn = gnn

    def forward(self, batch, *, train=False, generator=None):
        out, metrics = self.gnn(batch, train=train, generator=generator)
        h = out.node_table("output")
        mask = out.node_mask
        loss = torch.where(mask[:, None], h, torch.zeros((), dtype=h.dtype)).square().sum() / mask.sum().clamp_min(1)
        return loss, metrics


def _node_step(module, minibatch, budgets, group, lr, reorder="auto", node_aligned=()):
    """One SGD step of ``module`` on this rank's shard of ``minibatch`` over
    ``group``. Returns (loss, params, stats)."""
    from ptgnn_tpu_torch.parallel.node_sharding import NodeParallel

    npar = NodeParallel(module, node_group=group, reorder=reorder, node_aligned=node_aligned, **budgets)
    local = npar.shard_batch(minibatch)
    opt = torch.optim.SGD(module.parameters(), lr=lr)
    loss, _ = npar.train_step(_to(local), opt, generator=torch.Generator())
    module.gnn.node_group = None
    return float(loss), _params(module), npar.last_stats


# ---------------------------------------------------------------------------
# edge sharding
# ---------------------------------------------------------------------------
def edge_aggregate(payload, rank, world, tmp):
    """sharded_aggregate of each reduction: this rank's output and the
    gradient of <out, cot> with respect to its slots' messages."""
    from ptgnn_tpu_torch.parallel.edge_sharding import shard_adjacency, sharded_aggregate

    local = _to(shard_adjacency(payload["adj"], world)[rank])
    per = local.senders.shape[0]
    out = {}
    for reduction in ("sum", "mean", "max"):
        msgs = torch.from_numpy(payload["messages"][rank * per:(rank + 1) * per]).requires_grad_(True)
        agg = sharded_aggregate(msgs, local, payload["num_nodes"], reduction, dist.group.WORLD,
                                counts_exact=True)
        (agg * torch.from_numpy(payload["cot"])).sum().backward()
        out[reduction] = (agg.detach(), msgs.grad)
    return out


def edge_pna(payload, rank, world, tmp):
    from ptgnn_tpu_torch.graph.messagepassing.base import GraphContext
    from ptgnn_tpu_torch.graph.messagepassing.pna import PnaMessageAggregation
    from ptgnn_tpu_torch.parallel.edge_sharding import shard_adjacency

    local = _to(shard_adjacency(payload["adj"], world)[rank])
    per = local.senders.shape[0]
    ctx = GraphContext(adjacency=local, node_graph=torch.from_numpy(payload["node_graph"]),
                       node_mask=torch.from_numpy(payload["node_mask"]),
                       graph_mask=torch.from_numpy(payload["graph_mask"]), references={},
                       edge_group=dist.group.WORLD)
    msgs = torch.from_numpy(payload["messages"][rank * per:(rank + 1) * per])
    return PnaMessageAggregation()(msgs, ctx, payload["num_nodes"])


def edge_parallel_step(payload, rank, world, tmp):
    """One SGD step with the edges over 4 shards (the world) and over 2
    (each pair of ranks steps on the same minibatch)."""
    from ptgnn_tpu_torch.parallel.edge_sharding import EdgeParallel

    out = {}
    pairs = _pair_groups(world)
    for shards, group in ((world, dist.group.WORLD), (2, pairs[rank // 2])):
        module = _module(payload)
        ep = EdgeParallel(module, group=group)
        opt = torch.optim.SGD(module.parameters(), lr=payload["lr"])
        loss, metrics = ep.train_step(_to(ep.shard_batch(payload["minibatch"])), opt, generator=torch.Generator())
        module.gnn.edge_group = None
        out[shards] = {"loss": float(loss), "params": _params(module),
                       "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


# ---------------------------------------------------------------------------
# node sharding
# ---------------------------------------------------------------------------
def node_step(payload, rank, world, tmp):
    """One SGD step over 4 shards (the world) and over 2 (each pair of ranks
    steps on the same minibatch)."""
    out = {}
    pairs = _pair_groups(world)
    for shards, group in ((world, dist.group.WORLD), (2, pairs[rank // 2])):
        loss, params, stats = _node_step(_module(payload), payload["minibatch"], payload["budgets"][shards],
                                         group, payload["lr"])
        out[shards] = {"loss": loss, "params": params, "stats": stats}
    return out


def node_loss(payload, rank, world, tmp):
    """The loss and one SGD step over the world of a module given whole
    (``payload["module"]``, built by the parent)."""
    module = payload["module"]
    loss, params, stats = _node_step(module, payload["minibatch"], payload["budgets"], dist.group.WORLD,
                                     payload["lr"], payload.get("reorder", "auto"), payload.get("node_aligned", ()))
    return {"loss": loss, "params": params, "stats": stats}


def node_edge_dropout(payload, rank, world, tmp):
    """A node-sharded step with edge dropout 0.3: each rank drops its own
    slots (its slice of one draw for the group), and the step stays one
    step: every rank ends with the same parameters. Returns the loss, the
    parameters and the share of this rank's interior slots kept."""
    from ptgnn_tpu_torch.parallel.node_sharding import NodeParallel

    module = _module(payload)
    module.gnn.edge_dropout_rate = 0.3
    npar = NodeParallel(module, **payload["budgets"])
    local = _to(npar.shard_batch(payload["minibatch"]))
    opt = torch.optim.SGD(module.parameters(), lr=payload["lr"])
    kept = []
    hook = module.gnn.message_passing_layers[1].register_forward_pre_hook(
        lambda layer, args: kept.append(args[1].node_sharding.adj_int.mask.clone()))
    loss, _ = npar.train_step(local, opt, generator=torch.Generator().manual_seed(5))
    hook.remove()
    module.gnn.node_group = None
    real = local["batch"].adjacency.mask
    return {"loss": float(loss), "params": _params(module), "kept": float(kept[0].sum() / real.sum()),
            "mask": kept[0]}


def node_graphnorm(payload, rank, world, tmp):
    """GraphNorm over this rank's rows of a node-sharded table, with its
    gradient, against the same layer over the whole table."""
    from ptgnn_tpu_torch.graph.messagepassing.base import GraphContext
    from ptgnn_tpu_torch.parallel.node_sharding import NodeShardCtx

    layer = payload["layer"]
    rows = payload["x"].shape[0] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    x = torch.from_numpy(payload["x"][mine]).requires_grad_(True)
    ns = NodeShardCtx(group=dist.group.WORLD, shard_index=rank, rows_per=rows, adj_int=None, adj_bnd=None,
                      h_local=x, recv=None, node_graph_global=None, node_mask_global=None)
    ctx = GraphContext(adjacency=None, node_graph=torch.from_numpy(payload["node_graph"][mine]),
                       node_mask=torch.from_numpy(payload["node_mask"][mine]),
                       graph_mask=torch.from_numpy(payload["graph_mask"]), references={}, node_sharding=ns)
    out = layer(x, ctx)
    (out * torch.from_numpy(payload["cot"][mine])).sum().backward()
    return {"out": out.detach(), "grad": x.grad, "params": {n: p.grad for n, p in layer.named_parameters()}}


def node_large_graph(payload, rank, world, tmp):
    """Adam steps over the world on batches of one graph larger than a
    shard's rows: the losses."""
    from ptgnn_tpu_torch.parallel.node_sharding import NodeParallel

    module = _module(payload)
    npar = NodeParallel(module, **payload["budgets"])
    local = [_to(npar.shard_batch(mb)) for mb in payload["minibatches"]]
    opt = torch.optim.Adam(module.parameters(), lr=2e-3)
    losses = []
    for i in range(8):
        loss, _ = npar.train_step(local[i % len(local)], opt, generator=torch.Generator())
        losses.append(float(loss))
    rows = {k: tuple(v.shape) for k, v in local[0]["batch"].node_data.items() if hasattr(v, "shape")}
    return {"losses": losses, "rows": rows, "stats": npar.last_stats}


def node_interior_independent(payload, rank, world, tmp):
    """The interior aggregation does not read the exchange: with every
    boundary slot masked off, a NaN receive buffer leaves the loss finite
    and equal to the clean interior-only loss; with the boundary slots live
    it reaches the loss (the control)."""
    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.parallel import node_sharding as nsmod

    module = _module(payload)
    npar = nsmod.NodeParallel(module, **payload["budgets"])
    local = npar.shard_batch(payload["minibatch"])
    ns = local["batch"].node_sharding
    bnd_off = ns.adjacency_bnd._replace(mask=np.zeros_like(ns.adjacency_bnd.mask),
                                        agg_counts=np.zeros_like(ns.adjacency_bnd.agg_counts))
    interior_only = {**local, "batch": local["batch"]._replace(node_sharding=ns._replace(adjacency_bnd=bnd_off))}

    def loss_of(mb):
        with torch.no_grad():
            return float(module_loss(module, _to(mb), train=False)[0])

    clean = loss_of(interior_only)
    real_exchange = nsmod.exchange_boundary
    nsmod.exchange_boundary = lambda h, idx, group: real_exchange(h, idx, group) * float("nan")
    try:
        poisoned, control = loss_of(interior_only), loss_of(local)
    finally:
        nsmod.exchange_boundary = real_exchange
    module.gnn.node_group = None
    return {"clean": clean, "poisoned": poisoned, "control": control}


# ---------------------------------------------------------------------------
# the node-sharded trainer
# ---------------------------------------------------------------------------
def hybrid_step(payload, rank, world, tmp):
    """One step on the (data 2 x node 2) layout: node groups [0, 1] and
    [2, 3], each on its own minibatch; then the eval step at weights 1, 0."""
    from ptgnn_tpu_torch.parallel.node_sharded_trainer import node_data_groups
    from ptgnn_tpu_torch.parallel.node_sharding import NodeParallel

    node_group, data_group = node_data_groups(2)
    module = _module(payload)
    npar = NodeParallel(module, node_group=node_group, data_group=data_group, **payload["budgets"])
    d = rank // 2
    local = _to(npar.shard_batch(payload["minibatches"][d]))
    opt = torch.optim.SGD(module.parameters(), lr=payload["lr"])
    loss, metrics = npar.train_step(local, opt, weight=1.0, generator=torch.Generator())
    params = _params(module)
    module.load_state_dict(payload["state"])
    eloss, _, wsum = npar.data_parallel.eval_step(local, [1.0, 0.0][d])
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()}, "params": params,
            "eval_loss": float(eloss), "wsum": float(wsum)}


def zero1_moments(payload, rank, world, tmp):
    """ZeRO-1 over the data group of the (2 x 2) layout: each rank holds
    about half of Adam's moments, and the step equals the unsharded Adam's."""
    from ptgnn_tpu_torch.parallel.dp import moment_elements, zero1_optimizer
    from ptgnn_tpu_torch.parallel.node_sharded_trainer import node_data_groups
    from ptgnn_tpu_torch.parallel.node_sharding import NodeParallel

    node_group, data_group = node_data_groups(2)
    out = {}
    for zero in (True, False):
        module = _module(payload)
        npar = NodeParallel(module, node_group=node_group, data_group=data_group, **payload["budgets"])
        local = _to(npar.shard_batch(payload["minibatches"][rank // 2]))
        make = lambda params: torch.optim.Adam(params, lr=1e-3)  # noqa: E731
        opt = zero1_optimizer(module.parameters(), make, group=data_group) if zero else make(module.parameters())
        npar.train_step(local, opt, generator=torch.Generator())
        out[zero] = {"params": _params(module), "moments": moment_elements(opt)}
    out["total"] = 2 * sum(p.numel() for p in module.parameters())
    return out


def _trainer(payload, tmp, rank, **over):
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model
    from ptgnn_tpu_torch.implementations.typilus.harness import small_padding
    from ptgnn_tpu_torch.parallel.node_sharded_trainer import NodeShardedModelTrainer

    model = create_graph2class_gnn_model(hidden_state_size=32, padding=small_padding(max_nodes=256, max_graphs=8))
    kwargs = dict(node_shards=2, max_num_epochs=3, minibatch_size=8,
                  optimizer_creator=lambda params: torch.optim.Adam(params, lr=1e-3),
                  target_validation_metric="Accuracy", target_validation_metric_higher_is_better=True,
                  device="cpu")
    kwargs.update(over)
    return model, NodeShardedModelTrainer(model, Path(tmp) / "g2c.pkl.gz", **kwargs)


def _data(n, seed, **kw):
    from ptgnn_tpu_torch.core.data import LazyDataIterable
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    kw = {"mean_nodes": 60, "max_nodes": 120, **kw}
    return LazyDataIterable(lambda: synthetic_typilus_graphs(n, seed=seed, **kw))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: List[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _train(trainer, train, valid, **kw):
    handler = _Records()
    logging.getLogger("ptgnn_tpu_torch").addHandler(handler)
    logging.getLogger("ptgnn_tpu_torch").setLevel(logging.INFO)
    try:
        trainer.train(train, valid, parallelize=False, store_tensorized_data_in_memory=True, patience=5, **kw)
    finally:
        logging.getLogger("ptgnn_tpu_torch").removeHandler(handler)
    return handler.messages


def trainer_lifecycle(payload, rank, world, tmp):
    """The trainer end to end: (data 2 x node 2) with validation on start,
    a pure node layout (node 4), gradient accumulation, and a resume with
    the optimizer state; the budgets' probes and the pass stats logged."""
    from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2Class
    from ptgnn_tpu_torch.parallel.node_sharded_trainer import NodeShardedModelTrainer

    out = {}
    sub = Path(tmp) / "hybrid"
    sub.mkdir(exist_ok=True)
    model, trainer = _trainer(payload, sub, rank)
    messages = _train(trainer, _data(24, 1), _data(8, 2), validate_on_start=True)
    acc = model.report_accuracy(_data(8, 2), trainer.neural_module, device="cpu") if rank == 0 else None
    out["hybrid"] = {"budgets": trainer._budgets, "provisional": trainer._budgets_provisional,
                     "data_size": trainer.data_size, "messages": messages, "accuracy": acc,
                     "params": _params(trainer.neural_module), "saved": (sub / "g2c.pkl.gz").exists()}

    sub = Path(tmp) / "pure"
    sub.mkdir(exist_ok=True)
    model, trainer = _trainer(payload, sub, rank, node_shards=4, max_num_epochs=1)
    messages = _train(trainer, _data(16, 1), _data(6, 2), validate_on_start=False)
    out["pure"] = {"data_size": trainer.data_size, "messages": messages, "saved": (sub / "g2c.pkl.gz").exists()}

    sub = Path(tmp) / "accum"
    sub.mkdir(exist_ok=True)
    model, trainer = _trainer(payload, sub, rank, max_num_epochs=1, gradient_accumulation_steps=2)
    _train(trainer, _data(24, 1), _data(6, 2), validate_on_start=False)
    out["accum"] = {"saved": (sub / "g2c.pkl.gz").exists(), "steps": trainer._opt_steps_this_epoch}

    sub = Path(tmp) / "resume"
    sub.mkdir(exist_ok=True)
    model, trainer = _trainer(payload, sub, rank, max_num_epochs=2)
    _train(trainer, _data(16, 1), _data(6, 2), validate_on_start=False)
    ckpt = sub / "g2c.pkl.gz"
    has_state = ckpt.with_suffix(".optimizerstate").exists()
    dist.barrier()
    model2, _ = Graph2Class.restore_model(ckpt)
    trainer2 = NodeShardedModelTrainer(
        model2, ckpt, node_shards=2, max_num_epochs=3, minibatch_size=8,
        optimizer_creator=lambda params: torch.optim.Adam(params, lr=1e-3),
        target_validation_metric="Accuracy", target_validation_metric_higher_is_better=True, device="cpu",
    )
    trainer2.restore_parameters(ckpt, restore_optimizer=True)
    start = trainer2._start_epoch_override
    _train(trainer2, _data(16, 1), _data(6, 2), initialize_metadata=False, validate_on_start=False)
    out["resume"] = {"optimizer_state": has_state, "start_epoch": start,
                     "params": _params(trainer2.neural_module)}
    return out


def trainer_budgets(payload, rank, world, tmp):
    """Budgets: a minibatch over tiny frozen budgets is skipped with a
    warning (its slot runs the empty minibatch at weight 0); budgets probed
    on a small validation fold before training are provisional, and the
    first training pass probes again."""
    from ptgnn_tpu_torch.implementations.typilus.harness import small_padding  # noqa: F401

    out = {}
    sub = Path(tmp) / "skip"
    sub.mkdir(exist_ok=True)
    model, trainer = _trainer(payload, sub, rank,
                              budgets=dict(boundary_budget=1, interior_slots=128, boundary_slots=128))
    trainer.load_metadata_and_create_network(_data(8, 1), parallelize=False)
    mb, _ = next(model.minibatch_iterator(model.tensorize_dataset(iter(_data(8, 1)), parallelize=False),
                                          max_minibatch_size=8, parallelize=False))
    handler = _Records()
    handler.setLevel(logging.WARNING)
    trainer.LOGGER.addHandler(handler)
    skipped = trainer.shard_minibatch(mb)
    prepared, weight = trainer._prepare_minibatch(mb, 8.0)
    trainer.LOGGER.removeHandler(handler)
    out["skip"] = {"skipped_is_none": skipped is None, "count": trainer._epoch_shard_stats["skipped"],
                   "messages": handler.messages, "weight": weight,
                   "empty_nodes": int(prepared["batch"].num_nodes)}

    sub = Path(tmp) / "reprobe"
    sub.mkdir(exist_ok=True)
    model, trainer = _trainer(payload, sub, rank, node_shards=4, max_num_epochs=1)
    messages = _train(trainer, _data(16, 1), _data(6, 2, mean_nodes=20, max_nodes=40), validate_on_start=True)
    out["reprobe"] = {"messages": [m for m in messages if "budgets probed" in m],
                      "provisional": trainer._budgets_provisional,
                      "skipped": [m for m in messages if "batches skipped" in m]}
    return out


CASES: Dict[str, Callable] = {
    "edge_aggregate": edge_aggregate,
    "edge_pna": edge_pna,
    "edge_parallel_step": edge_parallel_step,
    "node_step": node_step,
    "node_loss": node_loss,
    "node_graphnorm": node_graphnorm,
    "node_edge_dropout": node_edge_dropout,
    "node_large_graph": node_large_graph,
    "node_interior_independent": node_interior_independent,
    "hybrid_step": hybrid_step,
    "zero1_moments": zero1_moments,
    "trainer_lifecycle": trainer_lifecycle,
    "trainer_budgets": trainer_budgets,
}
