"""The port's node-sharded trainer (``parallel/node_sharded_trainer.py``) on
4 gloo ranks (one spawned world for the module, ``tests/torch_shard_worker.py``):
the cases of ``tests/test_node_sharded_trainer.py`` and the Typilus
distributed CLI with ``--node-shards`` (``tests/test_clis.py:243``).

* The hybrid (data 2 x node 2) step over two different minibatches against
  JAX's ``NodeParallel`` trainer step on a (2, 2) CPU mesh, weights converted
  through ``convert.py``, dropout 0; metrics summed over the data axis; the
  eval step's weighted loss with a padding slot at weight 0.
* ZeRO-1 over the data group: each rank holds about half of Adam's moments,
  and the step equals the unsharded Adam's.
* The trainer end to end on (2 x 2) with validation on start (budgets
  probed, provisional, probed again), on a pure node layout (node 4),
  with gradient accumulation, and resumed with its optimizer state.
* A minibatch over frozen budgets is skipped with a warning; budgets probed
  on a small validation fold are raised by the first training pass.
* The CLI: ``--node-shards 2 --world-size 4 --device cpu`` trains two
  epochs and reports a test accuracy.

Tolerances: the loss rtol 1e-5; each parameter's update within 1e-4 of its
largest magnitude (``test_torch_parallel_dp.py``'s); ZeRO-1 against the
unsharded Adam within 1e-6 of each max."""
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
from ptgnn_tpu.parallel.node_sharding import NodeParallel as JaxNodeParallel
from ptgnn_tpu.parallel.node_sharding import suggest_budgets as jax_suggest_budgets
from ptgnn_tpu_torch.convert import jax_params_to_state_dict
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.parallel.node_sharding import suggest_budgets
from ptgnn_tpu_torch.utils.io import write_jsonl_gz
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs
from tests.torch_shard_worker import launch

ROOT = Path(__file__).resolve().parents[1]
# test_torch_parallel_dp.py's Graph2Class size, where the two packages'
# single-device steps agree to 1e-4 (at the JAX test's 60-node graphs max
# aggregation's near-ties already part them by up to 6e-3 of a max update:
# tests/test_torch_node_sharding.py, G2C).
KW = dict(num_metadata_graphs=32, mean_nodes=30, max_graph_nodes=80, hidden_state_size=32, num_minibatches=2,
          minibatch_size=4, dropout_rate=0.0)
LR = 0.05
CLI_TIMEOUT_S = 280


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, jmodule, params, jmbs = jax_build(padding=jax_small_padding(max_nodes=256, max_graphs=8), **KW)
    tmodel, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256, max_graphs=8), device="cpu",
                                              **KW)
    assert len(tmbs) == 2
    state = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, params))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "node"))
    npar = JaxNodeParallel(jmodule, optax.sgd(LR), mesh, axis="node", data_axis="data",
                           **jax_suggest_budgets(jmbs, 2))
    group = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *[npar.shard_batch(mb) for mb in jmbs])
    train_step, _ = npar.build_trainer_steps()
    p2 = jax.tree_util.tree_map(jnp.copy, params)
    jparams, _, jloss, jmetrics = train_step(p2, optax.sgd(LR).init(params), npar.device_put_batch(group),
                                             jax.random.PRNGKey(3), 1.0, npar.device_put_weights([1.0, 1.0]))
    jmodule.gnn.node_partition_axis = None
    eval_loss = float(jmodule.apply(params, **jmbs[0], train=False)[0])
    payload = {"model": tmodel, "state": state, "minibatches": tmbs, "budgets": suggest_budgets(tmbs, 2), "lr": LR}
    cases = [("hybrid_step", payload), ("zero1_moments", payload), ("trainer_lifecycle", {}),
             ("trainer_budgets", {})]
    ranks = launch(cases, tmp_path_factory.mktemp("trainer_world"), world=4)
    return {"tmodule": tmodule, "state": state, "jparams": jparams, "jloss": float(jloss),
            "jmetrics": {k: float(v) for k, v in jmetrics.items()}, "eval_loss": eval_loss, "ranks": ranks,
            "num_edges": sum(int(mb["batch"].num_edges) for mb in tmbs)}


def test_hybrid_step_matches_jax_mesh(world):
    jflat = {k: v.numpy() for k, v in
             jax_params_to_state_dict(world["tmodule"], jax.tree_util.tree_map(np.asarray, world["jparams"])).items()}
    for rank in world["ranks"]:
        got = rank[0]
        np.testing.assert_allclose(got["loss"], world["jloss"], rtol=1e-5)
        # metrics are summed over the data axis: both minibatches' edges
        assert got["metrics"]["num_edges"] == world["num_edges"] == world["jmetrics"]["num_edges"]
        for name, before in world["state"].items():
            update, jupdate = (got["params"][name] - before).numpy(), jflat[name] - before.numpy()
            np.testing.assert_allclose(update, jupdate, rtol=0, atol=1e-4 * max(np.abs(jupdate).max(), 1e-30),
                                       err_msg=name)
        # the eval step at weights (1, 0): the first minibatch's loss alone
        np.testing.assert_allclose(got["eval_loss"], world["eval_loss"], rtol=1e-5)
        assert got["wsum"] == 1.0


def test_zero1_moments_sharded_over_data_axis(world):
    for rank in world["ranks"]:
        got = rank[1]
        total = got["total"]
        assert 0.3 * total < got[True]["moments"] < 0.7 * total, (got[True]["moments"], total)
        assert got[False]["moments"] == total
        for name, want in got[False]["params"].items():
            torch.testing.assert_close(got[True]["params"][name], want, rtol=0,
                                       atol=1e-6 * float(want.abs().max()), msg=name)


def test_node_sharded_trainer_end_to_end_hybrid(world):
    for rank, got in enumerate(r[2]["hybrid"] for r in world["ranks"]):
        assert got["data_size"] == 2 and got["saved"]
        assert got["budgets"] is not None and got["provisional"] is False
        probes = [m for m in got["messages"] if "budgets probed" in m]
        assert any("validation" in m for m in probes) and any("training" in m for m in probes)
        assert any("Node-sharding pass stats" in m for m in got["messages"])
        if rank == 0:
            assert 0.0 <= got["accuracy"] <= 1.0
    for name, p in world["ranks"][0][2]["hybrid"]["params"].items():
        assert all(torch.equal(p, r[2]["hybrid"]["params"][name]) for r in world["ranks"][1:]), name


def test_node_sharded_trainer_pure_node_layout(world):
    for rank in world["ranks"]:
        got = rank[2]["pure"]
        assert got["data_size"] == 1 and got["saved"]


def test_node_sharded_trainer_gradient_accumulation(world):
    for rank in world["ranks"]:
        got = rank[2]["accum"]
        assert got["saved"] and got["steps"] >= 1


def test_node_sharded_trainer_resume_with_optimizer_state(world):
    for rank in world["ranks"]:
        got = rank[2]["resume"]
        assert got["optimizer_state"] and got["start_epoch"] == 2
    for name, p in world["ranks"][0][2]["resume"]["params"].items():
        assert all(torch.equal(p, r[2]["resume"]["params"][name]) for r in world["ranks"][1:]), name


def test_over_budget_batch_is_skipped_with_log(world):
    for rank in world["ranks"]:
        got = rank[3]["skip"]
        assert got["skipped_is_none"] and got["count"] >= 1
        assert any("exceeds the frozen node-sharding" in m for m in got["messages"])
        # the slot runs the empty minibatch at weight 0
        assert got["weight"] == 0.0 and got["empty_nodes"] == 0


def test_skipped_minibatch_samples_are_not_counted(world):
    """Each node group's second training minibatch is forced over budget:
    the epoch counts the samples of the slots that trained, on every rank,
    not the node's raw samples. Only the node's assembler (rank 0)
    reshards."""
    counts = [rank[3]["count"] for rank in world["ranks"]]
    assert len(counts[0]["skipped_graphs"]) == 2 and min(counts[0]["skipped_graphs"]) > 0  # node groups (0, 1), (2, 3)
    assert counts[0]["calls"] > 4 and all(c["calls"] == 0 and not c["skipped_graphs"] for c in counts[1:])
    skipped = sum(counts[0]["skipped_graphs"])
    (raw, _), = counts[0]["reported"]
    for got in counts:
        assert got["reported"] == [(raw, raw - skipped)], got


def test_budgets_reprobed_on_first_training_pass(world):
    for rank in world["ranks"]:
        got = rank[3]["reprobe"]
        assert any("validation" in m for m in got["messages"]) and any("training" in m for m in got["messages"])
        assert got["provisional"] is False
        assert got["skipped"] and all(m.endswith("0 batches skipped over budget.") for m in got["skipped"])


def test_typilus_traindistributed_cli_node_sharded(tmp_path):
    """``--node-shards 2`` on 4 gloo ranks: a (data 2 x node 2) layout
    trains two epochs with probed budgets, validation and the best
    checkpoint's restore, then reports the test accuracy."""
    for fold, n, seed in (("train", 16, 1), ("valid", 6, 2), ("test", 6, 3)):
        (tmp_path / fold).mkdir()
        write_jsonl_gz(tmp_path / fold / "data.jsonl.gz",
                       synthetic_typilus_graphs(n, seed=seed, mean_nodes=30, max_nodes=80))
    model_path = tmp_path / "nodesharded.pkl.gz"
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"  # four CPU ranks on one host
    proc = subprocess.Popen(
        [sys.executable, "-m", "ptgnn_tpu_torch.implementations.typilus.traindistributed",
         *(str(tmp_path / f) for f in ("train", "valid", "test")), str(model_path), "--max-num-epochs", "2",
         "--minibatch-size", "4", "--max-nodes", "256", "--node-shards", "2", "--world-size", "4",
         "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the CLI ran past {CLI_TIMEOUT_S} s and was killed")
    assert proc.returncode == 0, err[-3000:]
    assert model_path.exists()
    assert "Test accuracy:" in out
    log = (tmp_path / "logs" / "full.log").read_text()
    assert "Node-sharding budgets probed" in log and "node groups of 2" in log
