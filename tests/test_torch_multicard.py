"""The multi-card path of ``chip_smoke.py --world 4`` on 4 gloo ranks on the
CPU: the same rank function (``chip_smoke.world_rank``, ``device="cpu"``) at
a small size (``chip_smoke.world_sizes``: Graph2Class at hidden 32 on
256-node batches, a small PPI), in ONE spawned world for every case; the
compiled steps are plain calls here, so compiled against eager compares
two plain runs. Each rank records the gates of legs 2-6 and the epoch, and
the tests hold them:

* leg 2, ``DistributedModelTrainer`` with ZeRO-1 (Adam eps 1e-3; float32
  unclipped, bf16 AMP clipped at 1.0): step 1 within 1e-5 of each
  parameter's largest magnitude of one process's steps on the weighted mean
  gradient of the 4 minibatches a step, and step 3 within
  ``chip_smoke.WORLD_DP_SPREAD`` (4) times that reference's own spread over
  the other orders of its sum (at least 1e-5); compiled against
  eager bitwise; about a quarter of Adam's moments on each rank;
* leg 3, ``EdgeParallel`` over 4 shards: each SGD step within 1e-5 of each
  parameter's max of the single-device step, the losses to rtol 1e-5;
* leg 4, ``NodeParallel`` over 4 shards: the forward states bitwise the
  in-process 4-shard stack's; gradients within 1e-4 of each gradient's
  max of the unsharded step; steps as leg 3; PPI in bf16 AMP and float32
  under ``ppi_np_steps``' limits;
* leg 5, 2 data x 2 node: one step within 1e-4 of each update's max of the
  unsharded weighted-mean step (the loss to rtol 1e-5); ZeRO-1 moments
  split over the data group; the trainer's epoch compiled against eager
  bitwise;
* leg 6, ``DistributedCheckpointer`` with ZeRO-1: the round trip bitwise,
  the resumed step bitwise a twin run's step through a new DataParallel,
  and within 1e-5 of each parameter's max of the uninterrupted step;

and, in the same world, a DP + ZeRO-1 Adam step at world 4 against JAX's
``DataParallel(zero1=True)`` on a 4-device CPU mesh at the JAX dry run's
sizes (``__graft_entry__.py:65-73``), weights converted through
``convert.py``, dropout 0: the loss to rtol 1e-5, and each parameter's
update within lr / eps x 1e-4 of its tensor's largest weighted-mean
gradient: the gradient tolerance against JAX (1e-4 of the max,
``test_torch_trainer.py``; the two packages' gradients differ by up to
1.1e-4 of their max at this size) carried through Adam's first update,
lr g / (|g| + eps), whose slope in g is at most lr / eps. Adam's eps is
1e-3 on both sides, so that slope is 1: with the default 1e-8 the first
update is lr x sign(g) and the bound says nothing. The workers import no
JAX."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu.parallel.dp import DataParallel as JaxDataParallel
from ptgnn_tpu.parallel.dp import stack_minibatches
from ptgnn_tpu_torch.convert import jax_params_to_state_dict
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding

WORLD = 4
# The JAX dry run's data-parallel leg at 4 devices, dropout 0.
DRY_RUN = dict(num_metadata_graphs=24, mean_nodes=30, max_graph_nodes=80, hidden_state_size=32,
               num_minibatches=WORLD, minibatch_size=4, dropout_rate=0.0)
LR, ADAM_EPS = 1e-3, 1e-3
LEGS = ["world-nccl", "world-dp", "world-edge", "world-node", "world-hybrid", "world-checkpoint", "world-epoch"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    _, jmodule, params, jmbs = jax_build(padding=jax_small_padding(max_nodes=256, max_graphs=8), **DRY_RUN)
    tmodel, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256, max_graphs=8), device="cpu",
                                              **DRY_RUN)
    state = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, params))
    weights = [float(mb["batch"].num_graphs) for mb in tmbs]
    dp = JaxDataParallel(jmodule, optax.adam(LR, eps=ADAM_EPS), mesh, enable_amp=False, zero1=True)
    replicated = dp.device_put_params(jax.tree_util.tree_map(jnp.copy, params))
    jparams, _, jloss, jmetrics = dp.build_train_step()(
        replicated, dp.init_opt_state(replicated), dp.device_put_batch(stack_minibatches(jmbs)),
        jax.random.PRNGKey(0), 1.0, jnp.asarray(np.asarray(weights, np.float32)))
    tmp = tmp_path_factory.mktemp("multicard")
    torch.save({"model": tmodel, "state": state, "minibatches": tmbs, "weights": weights, "lr": LR,
                "eps": ADAM_EPS}, tmp / "extra.pt")
    ranks = chip_smoke.launch_world(WORLD, Path(tmp), device="cpu", extra="tests.torch_dp_worker:zero1_step_world")
    jflat = {k: v.numpy() for k, v in
             jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, jparams)).items()}
    return {"ranks": ranks, "state": state, "jflat": jflat, "jloss": float(jloss),
            "jmetrics": {k: float(v) for k, v in jmetrics.items()},
            "gmax": weighted_mean_gradient_max(tmodel, state, tmbs, weights)}


def weighted_mean_gradient_max(model, state, minibatches, weights):
    """Each parameter's largest |sum_r w_r g_r / sum_r w_r| in one process."""
    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.graph.structs import tree_to

    module = model.build_neural_module(device="cpu", seed=0)
    module.load_state_dict(state)
    total = {n: torch.zeros_like(p) for n, p in module.named_parameters()}
    for w, mb in zip(weights, minibatches):
        module.zero_grad(set_to_none=True)
        loss, _ = module_loss(module, tree_to(mb, torch.device("cpu")), train=True, generator=torch.Generator())
        loss.backward()
        for n, p in module.named_parameters():
            total[n] += w * p.grad
    return {n: float((g / sum(weights)).abs().max()) for n, g in total.items()}


def lines(rank, leg, which="held"):
    return [line for line in rank[which] if line.startswith(leg + ":")]


@pytest.mark.parametrize("leg", LEGS)
def test_every_gate_of_the_leg_holds_on_every_rank(world, leg):
    for rank in world["ranks"]:
        assert not lines(rank, leg, "failures"), lines(rank, leg, "failures")
        assert lines(rank, leg), f"rank {rank['rank']} held no gate of {leg}"


def test_the_legs_held_their_gates_in_full(world):
    """Every gate a leg holds on the card is held here too: the count per
    leg, the same on every rank."""
    want = {"world-nccl": 1, "world-dp": 12, "world-edge": 2, "world-node": 5, "world-hybrid": 5, "world-checkpoint": 2,
            "world-epoch": 3}
    for rank in world["ranks"]:
        assert {leg: len(lines(rank, leg)) for leg in LEGS} == want


def test_zero1_moments_are_split_over_the_ranks(world):
    """Leg 2's ZeRO-1 holds a share of Adam's moments on each rank, and the
    shares add up to all of them."""
    shares = [line for rank in world["ranks"] for line in lines(rank, "world-dp") if "moment elements" in line]
    assert len(shares) == 2 * WORLD
    extra = [rank["extra"] for rank in world["ranks"]]
    assert sum(e["moments"] for e in extra) == extra[0]["total"]
    assert all(0.5 / WORLD < e["moments"] / e["total"] < 2.0 / WORLD for e in extra), [e["moments"] for e in extra]


def test_zero1_step_at_world_four_matches_jax_data_parallel(world):
    for rank in world["ranks"]:
        got = rank["extra"]
        np.testing.assert_allclose(got["loss"], world["jloss"], rtol=1e-5)
        assert got["metrics"]["num_edges"] == world["jmetrics"]["num_edges"]
        for name, before in world["state"].items():
            update, jupdate = (got["params"][name] - before).numpy(), world["jflat"][name] - before.numpy()
            np.testing.assert_allclose(update, jupdate, rtol=0, atol=LR / ADAM_EPS * 1e-4 * world["gmax"][name],
                                       err_msg=name)
    first = world["ranks"][0]["extra"]["params"]
    for rank in world["ranks"][1:]:
        for name, value in rank["extra"]["params"].items():
            assert torch.equal(value, first[name]), name


def test_readings_are_recorded_on_every_rank(world):
    """The node exchange's boundary rows and bytes, the checkpoint's
    seconds, each epoch's seconds and steps (the second epoch capturing
    nothing new) and each rank's host tensorize seconds."""
    for rank in world["ranks"]:
        r = rank["readings"]
        assert 0 < r["node exchange"]["boundary_rows"] <= r["node exchange"]["nodes"]
        assert r["node exchange"]["bytes_per_layer"] <= r["node exchange"]["padded_bytes_per_layer"]
        assert set(r["checkpoint s"]) == {"stage_s", "commit_s", "restore_s"}
        assert r["epoch"]["steps"] >= 1 and r["epoch"]["tensorize_s"] > 0
        assert len(r["epoch"]["seconds"]) == chip_smoke.WORLD_EPOCHS == 2 and min(r["epoch"]["seconds"]) > 0
        assert len(set(r["epoch"]["captured"])) == 1
        assert r["dp float32 all-reduce per execution"][0] >= 3


def test_initialize_multi_host_under_gloo_touches_no_cuda(tmp_path, monkeypatch):
    """Under gloo the rank is not bound to a card: no CUDA call, and no
    LOCAL_RANK needed (torchrun's, or the rank modulo the local world size,
    binds a card under NCCL only)."""
    import torch.distributed as dist

    from ptgnn_tpu_torch.parallel import initialize_multi_host

    def no_cuda(*args, **kwargs):
        raise AssertionError("initialize_multi_host touched CUDA under gloo")

    for name in ("set_device", "device_count", "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    initialize_multi_host("gloo", f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("env,rank,cards,want", [
    ({"LOCAL_RANK": "3"}, 7, 8, 3),  # torchrun's environment wins
    ({"LOCAL_WORLD_SIZE": "2"}, 5, 8, 1),  # the rank modulo the local world size
    ({}, 6, 4, 2),  # else modulo the cards of this host
    ({"RANK": "5"}, -1, 4, 1),  # torchrun's RANK where no rank is given
])
def test_initialize_multi_host_binds_the_rank_to_its_card_under_nccl(tmp_path, monkeypatch, env, rank, cards, want):
    """Under NCCL the card is made current before the group is made, and the
    group gets it as its device_id; the process group itself is not made
    here (no NCCL on this machine)."""
    import torch.distributed as dist

    from ptgnn_tpu_torch.parallel import initialize_multi_host

    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: calls.append(("set_device", device)))
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    initialize_multi_host("nccl", f"file://{tmp_path}/store", world_size=8, rank=rank)
    device = torch.device("cuda", want)
    assert calls[0] == ("set_device", device)
    assert calls[1][0] == "nccl" and calls[1][1]["device_id"] == device
    assert calls[1][1]["rank"] == rank and calls[1][1]["world_size"] == 8


def test_distributed_trainer_refuses_a_device_that_is_not_current_under_nccl(tmp_path, monkeypatch):
    """Under NCCL the trainer's device must be this rank's card, the current
    device: cuda:1 while cuda:0 is current raises (a gloo group stands in
    for NCCL, whose backend name is patched in)."""
    import torch.distributed as dist

    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model
    from ptgnn_tpu_torch.parallel import DistributedModelTrainer, initialize_multi_host

    initialize_multi_host("gloo", f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        monkeypatch.setattr(dist, "get_backend", lambda *args: "nccl")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        model = create_graph2class_gnn_model(hidden_state_size=8, padding=small_padding(max_nodes=64, max_graphs=4))
        with pytest.raises(ValueError, match="must be this rank's card"):
            DistributedModelTrainer(model, tmp_path / "m.pkl.gz", device="cuda:1")
        trainer = DistributedModelTrainer(model, tmp_path / "m.pkl.gz", device="cuda:0")
        assert trainer.world_size == 1
        trainer = DistributedModelTrainer(model, tmp_path / "m.pkl.gz", device="cuda")  # the current card
        assert trainer.rank == 0
    finally:
        dist.destroy_process_group()


def test_data_parallel_is_freed_once_unreachable(tmp_path):
    """DDP's C++ reducer keeps its comm hook's state alive, so the hook gets
    a weak proxy of the DataParallel: a strong one would tie the object and
    its compiled steps' graphs to the reducer in a cycle the collector
    cannot see, and NCCL's group destruction waits for every graph that
    captured one of its collectives."""
    import gc
    import weakref

    import torch.distributed as dist

    from ptgnn_tpu_torch.parallel import initialize_multi_host
    from ptgnn_tpu_torch.parallel.dp import DataParallel

    initialize_multi_host("gloo", f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        dp = DataParallel(torch.nn.Linear(3, 2))
        freed = weakref.ref(dp)
        del dp
        gc.collect()
        assert freed() is None
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fails", [False, True])
def test_distributed_trainer_frees_its_graphs_after_training(tmp_path, monkeypatch, fails):
    """train() frees the compiled data-parallel steps' graphs at its end,
    also when it raises, so that the process group can be destroyed after
    it."""
    import torch.distributed as dist

    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model
    from ptgnn_tpu_torch.parallel import DistributedModelTrainer, initialize_multi_host
    from ptgnn_tpu_torch.parallel.dp import DataParallel
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    cleared = []
    real_clear = DataParallel.clear
    monkeypatch.setattr(DataParallel, "clear", lambda dp: cleared.append(dp) or real_clear(dp))
    initialize_multi_host("gloo", f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        graphs = list(synthetic_typilus_graphs(6, seed=1, mean_nodes=20, max_nodes=40))
        model = create_graph2class_gnn_model(hidden_state_size=8, padding=small_padding(max_nodes=64, max_graphs=4))
        trainer = DistributedModelTrainer(model, tmp_path / "m.pkl.gz", max_num_epochs=1, minibatch_size=2,
                                          device="cpu")

        def epoch_end(*args):
            assert not cleared, "the graphs were freed before training ended"
            if fails:
                raise RuntimeError("planted")

        trainer.register_train_epoch_end_hook(epoch_end)
        if fails:
            with pytest.raises(RuntimeError, match="planted"):
                trainer.train(graphs, graphs[:2], patience=0, parallelize=False)
        else:
            trainer.train(graphs, graphs[:2], patience=0, parallelize=False)
        assert trainer._dp is not None and trainer._dp in cleared
    finally:
        dist.destroy_process_group()
