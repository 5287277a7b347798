"""The padding autotuner (``ptgnn_tpu_torch/utils/autotune.py``) against the
JAX package's ``utils/autotune.py`` (``tests/test_autotune.py``), on the CPU:

* ``default_candidates`` is field for field JAX's, with and without
  reference budgets;
* ``clone_with_padding`` re-budgets the attributes JAX's does on a
  Graph2Class model (the padding, the per-graph node cap, the stop of a
  batch's extension) and leaves the original alone;
* the sweep ranks feasible candidates best first, and reports an infeasible
  one (no graph fits, or the build raises) instead of raising;
* ``autotune_task_model`` returns a clone at the picked padding that
  carries the metadata and trains;
* each of the four train CLIs runs ``--autotune`` over a two-candidate grid
  and trains at the pick."""
import dataclasses

import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.implementations.typilus.train import create_graph2class_gnn_model as jax_create_graph2class
from ptgnn_tpu.utils import autotune as jax_autotune
from ptgnn_tpu_torch.core.trainer import module_loss
from ptgnn_tpu_torch.graph.structs import BatchPadding, tree_to
from ptgnn_tpu_torch.implementations.graph2seq import train as g2s_train
from ptgnn_tpu_torch.implementations.ppi import train as ppi_train
from ptgnn_tpu_torch.implementations.ppi.harness import synthetic_ppi_samples
from ptgnn_tpu_torch.implementations.typilus import train as typilus_train
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class
from ptgnn_tpu_torch.implementations.varmisuse import train as vm_train
from ptgnn_tpu_torch.utils import autotune, io
from ptgnn_tpu_torch.utils.synthetic import (
    synthetic_graph2seq_samples,
    synthetic_typilus_graphs,
    synthetic_varmisuse_samples,
)
from tests.test_torch_ppi import _write_graphsage


def _fields(padding):
    return {f.name: getattr(padding, f.name) for f in dataclasses.fields(padding)}


@pytest.mark.parametrize("kwargs", [
    {},
    dict(max_nodes_options=(1024, 2048), slots_per_node_options=(5.0, 6.0)),
    dict(reference_budgets_fn=typilus_train.typilus_reference_budgets, edge_tile=64, agg_rows=128, agg_sum_tile=0),
    dict(max_nodes_options=(2048, 4096, 8192), slots_per_node_options=(24.0, 30.0, 36.0)),
])
def test_default_candidates_are_jaxs(kwargs):
    got, want = autotune.default_candidates(**kwargs), jax_autotune.default_candidates(**kwargs)
    assert [_fields(p) for p in got] == [_fields(p) for p in want]
    assert len(got) == len(kwargs.get("max_nodes_options", (1, 2, 3))) * len(kwargs.get("slots_per_node_options",
                                                                                       (1, 2, 3)))
    for c in got:
        assert c.max_edge_slots % c.edge_tile == 0 and c.max_edge_slots >= 5 * c.max_nodes - c.edge_tile


def test_clone_with_padding_rebudgets_what_jax_does():
    base = dict(max_nodes=512, max_edge_slots=512 * 6, max_graphs=8, edge_tile=128,
                reference_budgets=typilus_train.typilus_reference_budgets(512))
    new = dict(max_nodes=256, max_edge_slots=256 * 8, max_graphs=8, edge_tile=128,
               reference_budgets=typilus_train.typilus_reference_budgets(256))
    port = typilus_train.create_graph2class_gnn_model(padding=BatchPadding(**base))
    jax = jax_create_graph2class(padding=JaxBatchPadding(**base))
    port_clone = autotune.clone_with_padding(port, BatchPadding(**new))
    jax_clone = jax_autotune.clone_with_padding(jax, JaxBatchPadding(**new))
    for attr in ("max_nodes_per_graph", "stop_extending_minibatch_after_num_nodes"):
        assert getattr(port_clone.gnn_model, attr) == getattr(jax_clone.gnn_model, attr), attr
        assert getattr(port.gnn_model, attr) == getattr(jax.gnn_model, attr), attr
    assert _fields(port_clone.gnn_model.padding) == _fields(jax_clone.gnn_model.padding)
    assert port_clone.gnn_model.padding == BatchPadding(**new)
    assert port.gnn_model.padding.max_nodes == 512  # the original keeps its budgets
    assert port_clone.gnn_model.max_nodes_per_graph == 256


def _build(padding):
    _, module, mbs = build_graph2class(padding=padding, num_metadata_graphs=12, mean_nodes=30, max_graph_nodes=60,
                                       hidden_state_size=16, num_minibatches=1, minibatch_size=8, device="cpu")
    return module, mbs


def _small(max_nodes):
    return BatchPadding(max_nodes=max_nodes, max_edge_slots=max_nodes * 12 // 64 * 64, max_graphs=8, edge_tile=64,
                        reference_budgets=(("supernodes", 64), ("token-sequence", max_nodes)))


def test_sweep_ranks_feasible_candidates_and_reports_infeasible_ones():
    tiny = BatchPadding(max_nodes=16, max_edge_slots=64, max_graphs=2, edge_tile=64,
                        reference_budgets=(("supernodes", 8), ("token-sequence", 16)))
    results = autotune.sweep_paddings(_build, [_small(256), tiny, _small(192)], steps=2, amp=False)
    assert [r.padding.max_nodes for r in results[2:]] == [16]
    assert results[2].error is not None and results[2].edges_per_sec == 0.0
    assert all(r.error is None and r.edges_per_sec > 0 and r.real_edges > 0 for r in results[:2])
    assert results[0].edges_per_sec >= results[1].edges_per_sec
    for r in results[:2]:
        assert r.ms_per_step == pytest.approx(1e3 * r.real_edges / r.edges_per_sec)

    def failing(padding):
        raise ValueError("the budgets are too small for this stack")

    r = autotune.measure_padding(failing, _small(256), steps=1)
    assert r.error is not None and "too small" in r.error and r.ms_per_step == float("inf")


def _labelled(graphs, classes):
    """Learnable multi-class labels (a one-class vocabulary has loss 0)."""
    for g in graphs:
        for sn in g["supernodes"].values():
            sn["annotation"] = classes[sum(map(ord, sn["name"])) % len(classes)]
    return graphs


def test_autotune_task_model_retunes_keeps_metadata_and_skips_what_cannot_fit():
    graphs = _labelled(list(synthetic_typilus_graphs(8, seed=0, mean_nodes=60, max_nodes=100)), ["int", "str"])
    ok = BatchPadding(max_nodes=256, max_edge_slots=2560, max_graphs=8, edge_tile=32, agg_rows=32, agg_sum_tile=0,
                      reference_budgets=typilus_train.typilus_reference_budgets(256))
    tiny = dataclasses.replace(ok, max_nodes=32, max_edge_slots=320, max_graphs=2,
                               reference_budgets=typilus_train.typilus_reference_budgets(32))
    model = typilus_train.create_graph2class_gnn_model(hidden_state_size=16, padding=ok)
    tuned, results = autotune.autotune_task_model(model, graphs, minibatch_size=8, candidates=[tiny, ok], steps=2,
                                                  amp=False, parallelize=False, device="cpu")
    by_nodes = {r.padding.max_nodes: r for r in results}
    assert by_nodes[32].error == "no graphs fit" and by_nodes[256].error is None
    assert tuned.metadata_initialized and tuned.gnn_model.padding == ok and tuned is not model
    module = tuned.build_neural_module(device="cpu")
    mb = next(iter(tuned.minibatch_iterator(tuned.tensorize_dataset(iter(graphs), parallelize=False),
                                            max_minibatch_size=8, parallelize=False)))[0]
    loss, _ = module_loss(module, tree_to(mb, torch.device("cpu")), train=False)
    assert float(loss.detach()) > 0


# ---------------------------------------------------------------------------
# the four train CLIs
# ---------------------------------------------------------------------------
def _typilus(tmp_path):
    for i, fold in enumerate(("train", "valid", "test")):
        (tmp_path / fold).mkdir()
        io.write_jsonl_gz(tmp_path / fold / "part0.jsonl.gz", _labelled(
            list(synthetic_typilus_graphs(8, seed=10 + i, mean_nodes=40, max_nodes=80)), ["int", "str", "bool"]))
    return ([*(str(tmp_path / f) for f in ("train", "valid", "test")), str(tmp_path / "m.pkl.gz")],
            [typilus_train.default_padding(256), typilus_train.default_padding(512)])


def _ppi(tmp_path):
    for i, fold in enumerate(("train", "valid", "test")):
        _write_graphsage(tmp_path, fold, synthetic_ppi_samples(2, i, mean_nodes=40, num_labels=6, edges_per_node=3))
    return ([str(tmp_path), str(tmp_path / "m.pkl.gz"), "--minibatch-size", "2"],
            [ppi_train.ppi_padding(128), ppi_train.ppi_padding(256)])


def _varmisuse(tmp_path):
    for i, fold in enumerate(("train", "valid", "test")):
        (tmp_path / fold).mkdir()
        io.write_jsonl_gz(tmp_path / fold / "part0.jsonl.gz", synthetic_varmisuse_samples(6, seed=30 + i,
                                                                                          mean_tokens=20))
    return ([*(str(tmp_path / f) for f in ("train", "valid", "test")), str(tmp_path / "m.pkl.gz")],
            [vm_train.vm_padding(256), vm_train.vm_padding(512)])


def _graph2seq(tmp_path):
    for i, fold in enumerate(("train", "valid")):
        io.write_jsonl_gz(tmp_path / f"{fold}.jsonl.gz",
                          synthetic_graph2seq_samples(8, seed=40 + i, mean_nodes=25, max_nodes=50))
    return ([str(tmp_path / "train.jsonl.gz"), str(tmp_path / "valid.jsonl.gz"), str(tmp_path / "m.pkl.gz")],
            [g2s_train.g2s_padding(256), g2s_train.g2s_padding(512)])


CLIS = {"typilus": (typilus_train, _typilus), "ppi": (ppi_train, _ppi), "varmisuse": (vm_train, _varmisuse),
        "graph2seq": (g2s_train, _graph2seq)}


@pytest.mark.parametrize("task", sorted(CLIS))
def test_train_cli_autotunes_then_trains_at_the_pick(task, tmp_path, monkeypatch):
    cli, write = CLIS[task]
    monkeypatch.chdir(tmp_path)  # the train CLIs' log files go under the working directory
    args, candidates = write(tmp_path)
    sweeps = []

    def recording(*a, **kw):
        tuned, results = autotune.autotune_task_model(*a, **{**kw, "steps": 2})
        sweeps.append((kw["candidates"], results, tuned))
        return tuned, results

    monkeypatch.setattr(cli, "autotune_candidates", lambda: candidates)
    monkeypatch.setattr(cli, "autotune_task_model", recording)
    cli.run(cli.build_arg_parser().parse_args(
        ["--minibatch-size", "4", *args, "--autotune", "--max-num-epochs", "1", "--sequential-run", "--quiet",
         "--device", "cpu"]))
    (swept, results, tuned), = sweeps
    assert swept == candidates and len(results) == 2
    assert results[0].error is None and results[0].edges_per_sec > 0
    assert tuned.gnn_model.padding == results[0].padding
    saved, state = type(tuned).restore_model(tmp_path / "m.pkl.gz")
    assert saved.gnn_model.padding == results[0].padding
    assert all(np.isfinite(v.numpy()).all() for v in state.values() if v.is_floating_point())
