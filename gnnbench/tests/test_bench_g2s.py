"""Graph2Seq's cell on the CPU and its readers on hand-made traces: the
plain reference against the program at a small size (float32, every
dropout on), its control and faults, the traffic against the program's
minibatching and the published vocabularies, the layer marks' readers and
the step's FLOP count by hand; and the four-card Graph2Class cell's driver
on two gloo ranks with that cell's traffic file."""
import argparse
import copy
import subprocess
import sys
import time

import pytest
import torch

from gnnbench.drivers import train_dp, training
from gnnbench.harness import correctness, pool, report, spec, trace, weights
from gnnbench.metrics import decoder_ms_per_step, encoder_ms_per_step, g2s_step_mfu, keyed_dropout_ms_per_step

from .conftest import ROOT
from .test_bench_reference import cpu_run

E2E = [{"name": "train_edges_per_s", "unit": "edges/s"}, {"name": "train_step_p95_ms", "unit": "ms"},
       {"name": "setup_s", "unit": "s"}]


def small_g2s() -> spec.Cell:
    """``g2s.train`` cut to a test's size: 8 graphs of about 40 nodes a
    batch, a lexicon that fills small vocabularies."""
    cell = copy.deepcopy(spec.cell("g2s.train"))
    cell.config["padding"].update(max_nodes=512, max_edge_slots=4096, max_graphs=8, stop_extending_after_nodes=512,
                                  reference_budgets={"backbone_nodes": 512})
    cell.traffic["params"].update(mean_nodes=40, max_nodes=100, lexicon_size=300, lexicon_shift=20,
                                  corpus_names_per_graph=20)
    cell.traffic["pool_batches"] = 4
    cell.traffic["metadata_graphs"] = 32
    cell.end_to_end = E2E
    return cell


@pytest.mark.parametrize("name", ["g2s.train"])
def test_reference_follows_the_program(name):
    cell = small_g2s()
    out = cpu_run(cell)
    assert out["program"]["losses"][0] == pytest.approx(out["reference"]["losses"][0], rel=1e-5)
    gaps = correctness.gaps(out["program"], out["reference"])
    assert gaps["loss1_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4, gaps
    assert gaps["loss_gap"] < 5e-3 and gaps["change_gap"] < 5e-2, gaps
    assert out["windows"][0].steps >= 1 and out["windows"][0].edges > 0
    line = report.result(cell, argparse.Namespace(trace=0), out, out["device_kind"])
    assert set(line["metrics"]) == {"train_edges_per_s", "train_step_p95_ms", "setup_s"}
    assert set(line["checks"]) == set(correctness.limits(name)) and line["correct"]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, gnnbench.reference.g2s_ggnn_copy;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'ptgnn_tpu_torch', 'ptgnn_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _readings(cell, seed, **kw):
    meta = pool.metadata_graphs(cell.traffic, seed)
    _, module = spec.task("graph2seq").build(cell.config, meta, torch.device("cpu"))
    w0 = weights.make(module, seed, torch.device("cpu"))
    return w0, training.reference_readings(cell, seed, w0, torch.device("cpu"), **kw)


def test_dropout_draws_follow_the_seed():
    """Every dropout of the reference draws from the step's seed: another
    seed, another loss; the same seed, the same bits."""
    cell = small_g2s()
    seed = 41
    meta = pool.metadata_graphs(cell.traffic, seed)
    ref = spec.reference("g2s_ggnn_copy")
    ctx = ref.Context(cell.config, meta)
    _, module = spec.task("graph2seq").build(cell.config, meta, torch.device("cpu"))
    params = weights.make(module, seed, torch.device("cpu"))
    graphs = pool.pool(cell.config, cell.traffic, spec.task("graph2seq"), seed, 0, ctx.edge_types, 1)[0].graphs
    batch = ref.Batch(ctx, graphs, torch.device("cpu"))
    a, b, c = (float(ref.loss(ctx, batch, params, s)) for s in (5, 5, 6))
    assert a == b != c


def test_control_and_faults_read_gaps():
    """The TF32 control reads gradient gaps ten times and more the float32
    program's at this size (grad_gap about 1e-6, its losses bitwise); each
    fault reads a gap of 1e-4 and more."""
    cell = small_g2s()
    seed = 31
    w0, ref = _readings(cell, seed)
    control = correctness.gaps(training.reference_readings(cell, seed, w0, torch.device("cpu"), fmt="tf32"), ref)
    assert control["grad_gap"] > 1e-5 and control["grad_diff_median"] > 1e-4, control
    for fault in ("half", "frozen"):
        gaps = correctness.gaps(training.reference_readings(cell, seed, w0, torch.device("cpu"), fault=fault), ref)
        assert gaps["grad_gap"] > 1e-4 or gaps["loss_gap"] > 1e-4, (fault, gaps)
        if fault == "frozen":
            assert gaps["change_gap"] == pytest.approx(1.0)


def test_groups_fit_and_the_program_takes_them():
    cell = small_g2s()
    task = spec.task("graph2seq")
    meta = pool.metadata_graphs(cell.traffic, 5)
    groups = pool.pool(cell.config, cell.traffic, task, 5, 0, task.edge_types(meta), 4)
    model, _ = task.build(cell.config, meta, torch.device("cpu"))
    for g in groups:
        mb = task.minibatch(model, g.graphs)
        assert int(mb["batch"].num_edges) == g.edges and int(mb["batch"].num_nodes) == g.nodes
        assert int(mb["batch"].references["backbone_nodes"].mask.sum()) == g.references["backbone_nodes"]
        assert int((mb["target_lengths"] > 0).sum()) == g.references["target_sequences"] == len(g.graphs)


def test_traffic_fills_the_published_vocabularies():
    """At the cell's own traffic, the program's metadata pass and the
    reference both give the published widths: a 10,000-row node table and
    a 20,000-row output table; the first batches fill three quarters of
    the padding's nodes."""
    cell = spec.cell("g2s.train")
    meta = pool.metadata_graphs(cell.traffic, 2**31 + 9)
    task = spec.task("graph2seq")
    _, module = task.build(cell.config, meta, torch.device("cpu"))
    params = dict(module.named_parameters())
    assert params["gnn.node_embedder.embeddings.weight"].shape[0] == cell.config["embedder"]["vocabulary_size"] == 10000
    assert params["decoder.embedding.weight"].shape[0] == cell.config["decoder"]["vocabulary_size"] == 20000
    ctx = spec.reference("g2s_ggnn_copy").Context(cell.config, meta)
    assert len(ctx.vocab) == 10000 and len(ctx.out_vocab) == 20000
    assert len(ctx.edge_types) == 4
    first = pool.pool(cell.config, cell.traffic, task, 2**31 + 9, 0, ctx.edge_types, 2)
    assert min(g.nodes for g in first) >= 0.75 * cell.config["padding"]["max_nodes"]


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------
# ns from a step's mark 0 to its marks 4, 1, 5, 2, 3 and to the next step's 0
AT = {0: 0, 4: 3_000_000, 1: 4_000_000, 5: 6_000_000, 2: 9_000_000, 3: 9_500_000}
STEP = 9_600_000
KEYED = [(1_000_000, 1_200_000), (2_000_000, 2_100_000), (7_000_000, 7_300_000)]  # (begin, end) starts


def _marks(steps, drop=(), keyed=True):
    ops = []
    for s in range(steps):
        t0 = 1_000 + s * STEP
        marks = list(AT.items()) + ([(6, a) for a, _ in KEYED] + [(7, b) for _, b in KEYED] if keyed else [])
        for i, t in marks:
            if (s, i) not in drop:
                ops.append((f"void trace_mark_kernel<{i}>()", t0 + t, t0 + t + 1_000))
    return ops


def _run(device, steps, config="g2s_ggnn_copy", groups=None, shapes=None):
    tr = trace.summarize([(trace.WINDOW, False, 0, 10**12)] + [(n, True, a, b) for n, a, b in device])
    groups = groups or [pool.Group([], 10, 30)] * steps
    return report.LayerRun(spec.load_config(config), tr, steps, groups, {"launches": {}}, 1.0, 0, shapes or {})


def test_encoder_and_decoder_add_up_to_forward_and_backward():
    run = _run(_marks(20), 20)
    enc, dec = encoder_ms_per_step.read(run), decoder_ms_per_step.read(run)
    assert enc == pytest.approx(1e-6 * (AT[4] + AT[2] - AT[5]), rel=1e-12)
    assert dec == pytest.approx(1e-6 * (AT[5] - AT[4]), rel=1e-12)
    assert enc + dec == pytest.approx(1e-6 * AT[2], rel=1e-12)  # forward and backward
    # from each begin mark's end (1 us after its start) to its end mark
    assert keyed_dropout_ms_per_step.read(run) == pytest.approx(1e-6 * sum(b - a - 1_000 for a, b in KEYED))


def test_a_step_with_a_lost_layer_mark_is_left_out():
    steps = 200
    one = _run(_marks(steps, drop={(50, 5)}), steps)
    assert encoder_ms_per_step.read(one) == pytest.approx(1e-6 * (AT[4] + AT[2] - AT[5]), rel=1e-12)
    unpaired = _run(_marks(steps, drop={(60, 7)}), steps)
    assert keyed_dropout_ms_per_step.read(unpaired) == pytest.approx(1e-6 * sum(b - a - 1_000 for a, b in KEYED))
    three = _run(_marks(steps, drop={(10, 4), (40, 6), (90, 1)}), steps)
    assert all(r.read(three) is None for r in (encoder_ms_per_step, decoder_ms_per_step, keyed_dropout_ms_per_step))


def test_a_program_without_layer_marks_reads_nothing():
    """The parent's program marks the four phases alone; a program without
    keyed dropout reads no keyed time."""
    phases_only = [op for op in _marks(10, keyed=False) if not any(f"<{i}>" in op[0] for i in (4, 5))]
    run = _run(phases_only, 10)
    assert all(r.read(run) is None for r in (encoder_ms_per_step, decoder_ms_per_step, keyed_dropout_ms_per_step))
    no_keyed = _run(_marks(10, keyed=False), 10)
    assert encoder_ms_per_step.read(no_keyed) is not None and keyed_dropout_ms_per_step.read(no_keyed) is None


def test_g2s_flops_by_hand():
    """One small group: n 10 nodes, e 30 edges, m 4 memories, B 2 names,
    V 50 tokens, at the configuration's widths."""
    config = spec.load_config("g2s_ggnn_copy")
    group = pool.Group([], nodes=10, edges=30, references={"backbone_nodes": 4, "target_sequences": 2})
    shapes = {"decoder.embedding.weight": (50, 256)}
    gated = 8 * (2 * 30 * 128 * 128 + 2 * 10 * 3 * 128 * 256)
    summary = 2 * 10 * 256 * 256 + 2 * 10 * 256 + 2 * 10 * 8 * 256 + 2 * 2 * 2048 * 128
    memories = 2 * 2 * 4 * 128 * 128
    gru = 2 * 2 * 7 * 384 * (256 + 128)
    attention = 3 * 2 * 4 * 7 * 128
    vocab = 2 * 2 * 7 * (256 * 256 + 256 * 50)
    assert g2s_step_mfu.forward_flops(config, group, shapes) == gated + summary + memories + gru + attention + vocab
    run = _run([], 1, groups=[group], shapes=shapes)
    run.trace.window = (0, 10**9)  # one second
    assert g2s_step_mfu.read(run) == pytest.approx(100 * 3 * g2s_step_mfu.forward_flops(config, group, shapes) / 67e12)
    assert g2s_step_mfu.read(_run([], 1, shapes={})) is None  # another model's parameters


# ---------------------------------------------------------------------------
# g2c_mlp.dp4's driver
# ---------------------------------------------------------------------------
def test_dp4_traffic_runs_on_two_gloo_ranks(small, tmp_path, monkeypatch):
    """The four-card cell's own traffic file (the train_dp driver), on two
    CPU ranks at a small size: correct against the cell's limits."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = small("g2c_mlp.dp4", ranks=2)
    assert cell.traffic["driver"] == "train_dp" and spec.cell("g2c_mlp.dp4").ranks == 4
    cell.config["padding"].update(max_nodes=256, max_edge_slots=3072, stop_extending_after_nodes=256)
    cell.traffic["params"].update(mean_nodes=60, max_nodes=120)
    cell.traffic["pool_batches"] = 3
    torch.set_num_threads(2)
    train_dp.PACE_STEPS = 1
    args = argparse.Namespace(seed=2**32 + 5, seconds=0.5, trace=0, device="cpu", cell=cell, rank_hook=None)
    out = train_dp.run(cell, args, time.time(), torch.device("cpu"))
    ok, checks = correctness.judge(correctness.gaps(out["program"], out["reference"]),
                                   correctness.limits("g2c_mlp.dp4"))
    assert ok, checks
    assert len(out["windows"]) == 2 and all(w.steps >= 1 for w in out["windows"])
