"""The port's data parallelism on 2 gloo ranks (processes of their own,
``tests/torch_dp_worker.py``) against the JAX package's ``DataParallel`` on
a 2-device CPU mesh, on Graph2Class with weights converted through
``convert.py`` and dropout 0 (JAX's RNG cannot be reproduced):

* the cases of ``tests/test_parallel_dp.py``: a weighted step equals the
  mean of the per-batch gradients; ZeRO-1 holds about half of Adam's
  moments on each rank and steps as the unsharded optimizer does; a padding
  rank (the empty minibatch at weight 0) dilutes nothing;
* the cases of ``tests/test_distributed_trainer.py``: the trainer's groups,
  weights and padding equal JAX's single-host groups, and it trains two
  epochs with an uneven last group; accumulating two groups equals one step
  on the weighted mean gradient; and across nodes, a node that runs out of
  data feeds empty groups while another has some;
* the Typilus distributed CLI end to end with ``--device cpu --world-size 2``.

Every spawned process is joined with a timeout and killed on expiry.

Tolerances. Against the port's own weighted-mean step, computed in one
process from the per-batch gradients: every parameter within 1e-6 of its
tensor's largest magnitude (the all-reduce adds in another order). Against
JAX: each parameter's update within 1e-4 of its largest magnitude, the
gradient tolerance of ``test_torch_trainer.py`` (the two packages' Graph2Class
gradients of one batch differ by up to 1.1e-4 of their max at this size:
float32 rounding carried through eight layers); the loss to rtol 1e-5;
ZeRO-1 against the unsharded Adam within 1e-6 of each max.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu.parallel.distributed_trainer import DistributedModelTrainer as JaxDistributedModelTrainer
from ptgnn_tpu.parallel.dp import DataParallel as JaxDataParallel
from ptgnn_tpu.parallel.dp import stack_minibatches
from ptgnn_tpu_torch.convert import jax_params_to_state_dict
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model
from ptgnn_tpu_torch.utils.io import write_jsonl_gz
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs
from tests.torch_dp_worker import launch

ROOT = Path(__file__).resolve().parents[1]
KW = dict(num_metadata_graphs=32, mean_nodes=30, max_graph_nodes=80, hidden_state_size=32, num_minibatches=4,
          minibatch_size=4, dropout_rate=0.0)
CLI_TIMEOUT_S = 400


@pytest.fixture(scope="module")
def setup():
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    jmodel, jmodule, params, jmbs = jax_build(padding=jax_small_padding(max_nodes=256, max_graphs=8), **KW)
    tmodel, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256, max_graphs=8), device="cpu", **KW)
    state = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, params))
    return mesh, jmodel, jmodule, params, jmbs, tmodel, state, tmbs


def assert_step_matches(port, module, weights, minibatches, jax_params, lr=0.1):
    """``port`` (a rank's parameters after one SGD step) against the port's
    weighted mean of per-batch gradients, and its update against JAX's."""
    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.graph.structs import tree_to

    total = {n: torch.zeros_like(p) for n, p in module.named_parameters()}
    for w, mb in zip(weights, minibatches):
        module.zero_grad(set_to_none=True)
        loss, _ = module_loss(module, tree_to(mb, torch.device("cpu")), train=True, generator=torch.Generator())
        loss.backward()
        for n, p in module.named_parameters():
            total[n] += w * p.grad
    jflat = {k: v.numpy() for k, v in
             jax_params_to_state_dict(module, jax.tree_util.tree_map(np.asarray, jax_params)).items()}
    assert set(port) == set(total) == set(jflat)
    for name, p in module.named_parameters():
        before = p.detach()
        want = before - lr * total[name] / max(sum(weights), 1e-9)
        torch.testing.assert_close(port[name], want, rtol=0, atol=1e-6 * float(want.abs().max()), msg=name)
        update, jupdate = (port[name] - before).numpy(), jflat[name] - before.numpy()
        np.testing.assert_allclose(update, jupdate, rtol=0, atol=1e-4 * max(np.abs(jupdate).max(), 1e-30),
                                   err_msg=name)


def jax_step(mesh, jmodule, params, minibatches, weights, optimizer):
    dp = JaxDataParallel(jmodule, optimizer, mesh)
    p_rep = dp.device_put_params(jax.tree_util.tree_map(jnp.copy, params))
    new_params, _, loss, metrics = dp.build_train_step()(
        p_rep, dp.init_opt_state(p_rep), dp.device_put_batch(stack_minibatches(minibatches)),
        jax.random.PRNGKey(0), 1.0, jnp.asarray(np.asarray(weights, np.float32)))
    return new_params, float(loss), metrics


def port_module(tmodel, state):
    module = tmodel.build_neural_module(device="cpu", seed=0)
    module.load_state_dict(state)
    return module


def test_dp_step_matches_mean_of_per_batch_grads(setup, tmp_path):
    mesh, _, jmodule, params, jmbs, tmodel, state, tmbs = setup
    weights = [float(mb["batch"].num_graphs) for mb in tmbs[:2]]
    expected, jloss, jmetrics = jax_step(mesh, jmodule, params, jmbs[:2], weights, optax.sgd(0.1))
    ranks = launch("sgd_step", {"model": tmodel, "state": state, "minibatches": tmbs[:2], "weights": weights},
                   tmp_path)
    module = port_module(tmodel, state)
    for r in ranks:
        assert_step_matches(r["params"], module, weights, tmbs[:2], expected)
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
        for k, v in jmetrics.items():
            assert r["metrics"][k] == pytest.approx(float(v)), k
        # the weight total, DDP's gradient buckets, then the loss and metrics
        assert r["allreduce_calls"] >= 3
        assert r["allreduce_bytes"] == 4 * (1 + sum(p.numel() for p in module.parameters()) + 1 + len(r["metrics"]))
    for name in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name


def test_share_of_a_lone_rank_is_exactly_one():
    """At world size 1 a rank's share w / sum(w) must be exactly 1, so that
    its step is the single-device trainer's: a true division, where a
    Python number over a tensor (a multiply by the reciprocal) misses 1 for
    some weights."""
    from ptgnn_tpu_torch.parallel.dp import _ratio

    weights = torch.arange(1, 5001, dtype=torch.float32)
    assert any(float(w) / t != 1.0 for w, t in zip(weights.tolist(), weights)), "the reciprocal should miss 1"
    assert all(float(_ratio(w, t)) == 1.0 for w, t in zip(weights.tolist(), weights))
    assert float(_ratio(0.0, torch.tensor(0.0))) == 0.0


def test_world_one_trainer_equals_model_trainer_with_shuffle(tmp_path):
    """DistributedModelTrainer on one gloo rank, ZeRO-1 on, trains two
    shuffled epochs bit for bit as ModelTrainer does from the same seed:
    node 0 keeps the single-device shuffle order and dropout seeds."""
    graphs = list(synthetic_typilus_graphs(24, seed=4, mean_nodes=30, max_nodes=80))
    models = {name: create_graph2class_gnn_model(hidden_state_size=32, dropout_rate=0.1,
                                                 padding=small_padding(max_nodes=256, max_graphs=8))
              for name in ("single", "ranked")}
    (result,) = launch("world_one", {"graphs": graphs, **models}, tmp_path, world=1)
    assert set(result["single"]) == set(result["ranked"])
    for name, want in result["single"].items():
        assert torch.equal(result["ranked"][name], want), name


def test_zero1_shards_optimizer_state(setup, tmp_path):
    _, _, _, _, _, tmodel, state, tmbs = setup
    weights = [float(mb["batch"].num_graphs) for mb in tmbs[:2]]
    ranks = launch("zero1", {"model": tmodel, "state": state, "minibatches": tmbs[:2], "weights": weights},
                   tmp_path)
    total = ranks[0]["total"]
    shares = [r["zero1"]["moments"] / total for r in ranks]
    assert sum(r["zero1"]["moments"] for r in ranks) == total
    assert all(0.3 <= s <= 0.7 for s in shares), shares
    assert all(r["full"]["moments"] == total for r in ranks)
    for r in ranks:
        for name, want in r["full"]["params"].items():
            got = r["zero1"]["params"][name]
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    for name in ranks[0]["zero1"]["params"]:
        assert torch.equal(ranks[0]["zero1"]["params"][name], ranks[1]["zero1"]["params"][name]), name


def test_weighted_step_ignores_padding_batches(setup, tmp_path):
    """Rank 1 gets the model's empty minibatch at weight 0: the step is rank
    0's alone, as JAX's with the same padding slot; the padding batch's loss
    and gradients are finite (NaN x 0 would poison the sum)."""
    mesh, jmodel, jmodule, params, jmbs, tmodel, state, tmbs = setup
    jempty = jmodel.finalize_minibatch(jmodel.initialize_minibatch())
    tempty = tmodel.finalize_minibatch(tmodel.initialize_minibatch())
    weights = [float(tmbs[0]["batch"].num_graphs), 0.0]
    expected, jloss, _ = jax_step(mesh, jmodule, params, [jmbs[0], jempty], weights, optax.sgd(0.1))
    ranks = launch("sgd_step", {"model": tmodel, "state": state, "minibatches": [tmbs[0], tempty],
                                "weights": weights}, tmp_path)
    module = port_module(tmodel, state)
    for r in ranks:
        assert_step_matches(r["params"], module, weights, [tmbs[0], tempty], expected)
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)

    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.graph.structs import tree_to

    loss, _ = module_loss(module, tree_to(tempty, torch.device("cpu")), train=True, generator=torch.Generator())
    loss.backward()
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all() for p in module.parameters())


def test_distributed_trainer_trains_with_uneven_groups(setup, tmp_path):
    """The groups of 2 slots over batches of 3 graphs, weights and the
    padding of the short last group equal JAX's single-host groups (batch
    arrays bitwise), rank 1's handed over by rank 0, the node's assembler,
    which alone makes the node's stream; then two epochs of training on 2
    ranks end with the same parameters on both, a checkpoint and the
    optimizer state."""
    _, jmodel, _, _, _, tmodel, _, _ = setup
    graphs = list(synthetic_typilus_graphs(40, seed=1, mean_nodes=30, max_nodes=80))
    jtrainer = JaxDistributedModelTrainer(jmodel, tmp_path / "jax.pkl.gz", mesh=Mesh(np.asarray(jax.devices()[:2]),
                                                                                      ("data",)))
    jgroups = list(jtrainer._group_minibatches(jmodel.minibatch_iterator(
        jmodel.tensorize_dataset(iter(graphs), parallelize=False), max_minibatch_size=3,
        yield_partial_minibatches=False, parallelize=False)))
    fresh = create_graph2class_gnn_model(hidden_state_size=32, padding=small_padding(max_nodes=256, max_graphs=8))
    ranks = launch("groups", {"model": tmodel, "graphs": graphs, "fresh_model": fresh}, tmp_path)
    assert jgroups[-1][2][-1] == 0.0, "the data should leave the last group short"
    for rank, r in enumerate(ranks):
        assert r["streams"] == (1 if rank == 0 else 0), "only the node's assembler makes its stream"
        assert len(r["groups"]) == len(jgroups)
        for got, (stacked, raw, weights) in zip(r["groups"], jgroups):
            assert got["weight"] == weights[rank] and got["num_raw"] == len(raw)
            jadj = stacked["batch"].adjacency
            for name in ("senders", "receivers", "edge_types", "mask", "edge_feature_slot"):
                np.testing.assert_array_equal(getattr(got["batch"]["batch"].adjacency, name),
                                              np.asarray(getattr(jadj, name))[rank], err_msg=name)
            np.testing.assert_array_equal(got["batch"]["target_classes"], np.asarray(stacked["target_classes"])[rank])
            for key, value in got["batch"]["batch"].node_data.items():
                np.testing.assert_array_equal(value, np.asarray(stacked["batch"].node_data[key])[rank])
        assert len(r["epochs"]) == 2 and 0.0 <= r["accuracy"] <= 1.0
        assert all(np.isfinite(e["Accuracy"]) for e in r["epochs"])
        assert r["checkpoint"] and r["optimizer_state"]
    for name in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name


def test_nodes_that_run_out_feed_empty_groups(setup, tmp_path):
    """Two nodes of one rank each, reading their own graphs (12 and 6, so 4
    and 2 full batches of 3): after every group the ranks agree whether
    anyone has data left, so both run 4 steps, the node that ran out with
    the empty minibatch at weight 0, as JAX's multi-host groups do; the
    parameters stay equal on both."""
    _, _, _, _, _, tmodel, _, _ = setup
    graphs = [list(synthetic_typilus_graphs(n, seed=11 + i, mean_nodes=30, max_nodes=80)) for i, n in enumerate((12, 6))]
    ranks = launch("nodes", {"model": tmodel, "graphs": graphs}, tmp_path)
    assert [r["node_rank"] for r in ranks] == [0, 1]
    assert len(ranks[0]["weights"]) == len(ranks[1]["weights"]) == 4
    assert all(w > 0 for w in ranks[0]["weights"])
    assert all(w > 0 for w in ranks[1]["weights"][:2]) and ranks[1]["weights"][2:] == [0.0, 0.0]
    for name in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name


def test_dp_gradient_accumulation_matches_weighted_mean_step(setup, tmp_path):
    """Two accumulated groups with weights [3, 1] and [2, 0] apply one SGD
    step on the weighted mean gradient of the four batches, as JAX's
    ``build_accum_steps`` does."""
    mesh, _, jmodule, params, jmbs, tmodel, state, tmbs = setup
    weights = [[3.0, 1.0], [2.0, 0.0]]
    dp = JaxDataParallel(jmodule, optax.sgd(0.1), mesh)
    grad_step, apply_step = dp.build_accum_steps()
    acc = jax.tree_util.tree_map(lambda p: jnp.zeros(jnp.shape(p), jnp.float32), params)
    w_acc = jnp.float32(0.0)
    for g, w in enumerate(weights):
        acc, w_acc, _, _ = grad_step(params, acc, w_acc, dp.device_put_batch(stack_minibatches(jmbs[2 * g:2 * g + 2])),
                                     jax.random.PRNGKey(g), dp.device_put_weights(np.asarray(w, np.float32)))
    opt_state = optax.sgd(0.1).init(params)
    expected, _ = apply_step(jax.tree_util.tree_map(jnp.copy, params), opt_state, acc, w_acc, 1.0)
    ranks = launch("accumulate", {"model": tmodel, "state": state, "minibatches": tmbs[:4], "weights": weights},
                   tmp_path)
    module = port_module(tmodel, state)
    for r in ranks:
        assert_step_matches(r["params"], module, [w for ws in weights for w in ws], tmbs[:4], expected)


def test_dp_step_pair_with_new_weights_and_rates_matches_jax_and_eager(setup, tmp_path):
    """The compiled step pair (``core/compiled_step.py``: on the CPU a plain
    call) over two accumulation windows, the second with other weights and
    another ``lr_factor``: after each window the parameters equal those of
    the functions it compiles, called directly, bit for bit; the first
    window equals JAX's ``build_accum_steps`` (its ``lr_factor`` scales the
    update, SGD's the rate: the same step) within the JAX tolerance, and
    the second the port's own weighted mean step from the first window's
    parameters within 1e-6 (JAX's second window starts from JAX's own first
    one, whose max-aggregation near-ties may route otherwise). A step that
    kept the first call's weight or rate would miss the second window."""
    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.graph.structs import tree_to

    mesh, _, jmodule, params, jmbs, tmodel, state, tmbs = setup
    weights = [[[3.0, 1.0], [2.0, 0.0]], [[1.0, 4.0], [0.0, 2.0]]]
    lr_factors = [0.5, 0.25]
    dp = JaxDataParallel(jmodule, optax.sgd(0.1), mesh)
    grad_step, apply_step = dp.build_accum_steps()
    acc = jax.tree_util.tree_map(lambda p: jnp.zeros(jnp.shape(p), jnp.float32), params)
    w_acc = jnp.float32(0.0)
    for g, w in enumerate(weights[0]):
        acc, w_acc, _, _ = grad_step(params, acc, w_acc, dp.device_put_batch(stack_minibatches(jmbs[2 * g:2 * g + 2])),
                                     jax.random.PRNGKey(g), dp.device_put_weights(np.asarray(w, np.float32)))
    expected, _ = apply_step(jax.tree_util.tree_map(jnp.copy, params), optax.sgd(0.1).init(params), acc, w_acc,
                             lr_factors[0])
    ranks = launch("step_pair", {"model": tmodel, "state": state, "minibatches": tmbs[:4], "weights": weights,
                                 "lr_factors": lr_factors}, tmp_path)
    module = port_module(tmodel, state)
    flat_weights = [[w for ws in window for w in ws] for window in weights]
    for r in ranks:
        for compiled, eager in zip(r["compiled"], r["eager"]):
            for name, value in compiled.items():
                assert torch.equal(value, eager[name]), name
        assert_step_matches(r["compiled"][0], module, flat_weights[0], tmbs[:4], expected, lr=0.1 * lr_factors[0])
    second = port_module(tmodel, {**state, **ranks[0]["compiled"][0]})
    total = {n: torch.zeros_like(p) for n, p in second.named_parameters()}
    for w, mb in zip(flat_weights[1], tmbs[:4]):
        second.zero_grad(set_to_none=True)
        loss, _ = module_loss(second, tree_to(mb, torch.device("cpu")), train=True, generator=torch.Generator())
        loss.backward()
        for n, p in second.named_parameters():
            total[n] += w * p.grad
    for r in ranks:
        for name, p in second.named_parameters():
            want = p.detach() - 0.1 * lr_factors[1] * total[name] / sum(flat_weights[1])
            torch.testing.assert_close(r["compiled"][1][name], want, rtol=0,
                                       atol=1e-6 * float(want.abs().max()), msg=name)
    for name in ranks[0]["compiled"][-1]:
        assert torch.equal(ranks[0]["compiled"][-1][name], ranks[1]["compiled"][-1][name]), name


def run_cli(argv, cwd):
    """The CLI in a process group of its own, killed with the ranks it
    spawned if it runs past the timeout."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen([sys.executable, "-m", "ptgnn_tpu_torch.implementations.typilus.traindistributed", *argv],
                            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the CLI ran past {CLI_TIMEOUT_S} s and was killed")
    assert proc.returncode == 0, err[-3000:]
    return out


def test_typilus_traindistributed_cli_on_two_cpu_ranks(tmp_path):
    """One epoch on 2 gloo ranks (ZeRO-1), then a second run restored from
    its checkpoint with ``--no-zero1``."""
    for fold, n, seed in (("train", 16, 1), ("valid", 6, 2), ("test", 6, 3)):
        (tmp_path / fold).mkdir()
        write_jsonl_gz(tmp_path / fold / "data.jsonl.gz",
                       synthetic_typilus_graphs(n, seed=seed, mean_nodes=30, max_nodes=80))
    folds = [str(tmp_path / fold) for fold in ("train", "valid", "test")]
    common = ["--max-num-epochs", "1", "--minibatch-size", "4", "--max-nodes", "256", "--world-size", "2",
              "--device", "cpu"]
    model_path = tmp_path / "dist.pkl.gz"
    out = run_cli([*folds, str(model_path), *common], tmp_path)
    assert model_path.exists() and model_path.with_suffix(".optimizerstate").exists()
    assert "Test accuracy:" in out
    log = (tmp_path / "logs" / "full.log").read_text()
    assert "r0]" in log and "r1]" in log
    out = run_cli([*folds, str(tmp_path / "restored.pkl.gz"), *common, "--restore-path", str(model_path),
                   "--no-zero1"], tmp_path)
    assert "Test accuracy:" in out
