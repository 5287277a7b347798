"""The control and the planted faults.

The control is the reference computed at the precision below the
configuration's, put in the program's place; at a test's size it must read
a gap well above float32's round-off. Each fault is planted in the timed path of a whole CPU
run, which must then come out not correct against the cell's limits: a step
that leaves the state unchanged, half of each batch left out of the mean,
and on several ranks the exchange between them left out."""
import argparse
import time

import pytest
import torch

from gnnbench.drivers import train_dp, training
from gnnbench.harness import correctness, pool, spec, weights

from .test_bench_reference import cpu_run

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


@pytest.mark.parametrize("name", ["g2c_mlp.train", "ppi.train_bf16"])
def test_control_reads_a_gap(small, name):
    cell = small(name)
    seed = 31
    meta = pool.metadata_graphs(cell.traffic, seed)
    _, module = spec.task(cell.config["task"]).build(cell.config, meta, torch.device("cpu"))
    w0 = weights.make(module, seed, torch.device("cpu"))
    ref = training.reference_readings(cell, seed, w0, torch.device("cpu"))
    control = training.reference_readings(cell, seed, w0, torch.device("cpu"),
                                          fmt=CONTROL[cell.config["precision"]["dtype"]])
    gaps = correctness.gaps(control, ref)
    assert gaps["grad_gap"] > 1e-4 or gaps["loss_gap"] > 1e-4, gaps
    assert gaps["grad_diff_median"] > 10 * gaps["grad_gap_median"], gaps  # rounding moves every element


def _judge(cell_name, out):
    ok, _ = correctness.judge(correctness.gaps(out["program"], out["reference"]), correctness.limits(cell_name))
    return ok


@pytest.mark.parametrize("name", ["g2c_mlp.train", "ppi.train_bf16"])
def test_unchanged_state_is_not_correct(small, monkeypatch, name):
    from ptgnn_tpu_torch.core import trainer

    monkeypatch.setattr(trainer.TrainStep, "_update", lambda self: torch._foreach_zero_(self._grads))
    assert not _judge(name, cpu_run(small(name)))


def _half_mask(mask):
    kept = torch.cumsum(mask.long(), 0) <= (mask.sum() // 2)
    return mask & kept


@pytest.mark.parametrize("name", ["g2c_mlp.train", "ppi.train_bf16"])
def test_half_batch_is_not_correct(small, monkeypatch, name):
    from ptgnn_tpu_torch.implementations.ppi.ppi import PPIClassification
    from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2ClassModule

    g2c_logits, ppi_logits = Graph2ClassModule._logits, PPIClassification.logits

    def g2c(self, batch, **kw):
        logits, idx, mask, metrics = g2c_logits(self, batch, **kw)
        return logits, idx, _half_mask(mask), metrics

    def ppi(self, batch, **kw):
        logits, mask, metrics = ppi_logits(self, batch, **kw)
        return logits, _half_mask(mask), metrics

    monkeypatch.setattr(Graph2ClassModule, "_logits", g2c)
    monkeypatch.setattr(PPIClassification, "logits", ppi)
    assert not _judge(name, cpu_run(small(name)))


def no_exchange():
    """Planted in each rank: DDP's all-reduce of a gradient bucket left out
    (each rank keeps its own gradient)."""
    from ptgnn_tpu_torch.parallel import dp

    def local(state, bucket):
        fut = torch.futures.Future()
        fut.set_result(bucket.buffer())
        return fut

    dp._counting_allreduce_hook = local


def _dp_run(cell, hook=None):
    torch.set_num_threads(2)
    args = argparse.Namespace(seed=2**32 + 3, seconds=0.5, trace=0, device="cpu", cell=cell, rank_hook=hook)
    train_dp.PACE_STEPS = 1
    return train_dp.run(cell, args, time.time(), torch.device("cpu"))


def test_dp_without_exchange_is_not_correct(small, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = small("g2c_mlp.train", ranks=2)
    cell.traffic["driver"] = "train_dp"
    cell.config["padding"].update(max_nodes=256, max_edge_slots=3072, stop_extending_after_nodes=256)
    cell.traffic["params"].update(mean_nodes=60, max_nodes=120)
    cell.traffic["pool_batches"] = 3
    sound = _dp_run(cell)
    broken = _dp_run(cell, "gnnbench.tests.test_bench_control:no_exchange")
    assert not _judge("g2c_mlp.train", broken)
    sound_gaps = correctness.gaps(sound["program"], sound["reference"])
    broken_gaps = correctness.gaps(broken["program"], broken["reference"])
    assert broken_gaps["grad_gap"] > 10 * sound_gaps["grad_gap"], (sound_gaps, broken_gaps)


def test_calibration_fails_a_control_that_passes(capsys):
    from gnnbench import calibrate

    limits = correctness.limits("g2c_mlp.train")
    below = {k: 0.5 * v for k, v in limits.items()}
    above = {k: 2.0 * v for k, v in limits.items()}
    sound = {"program": [{"seed": 1, "gaps": below}], "controls": [{"seed": 1, "control_tf32": above}]}
    assert calibrate.judged("g2c_mlp.train", sound)
    loose = {"program": [{"seed": 1, "gaps": below}], "controls": [{"seed": 1, "control_tf32": below}]}
    assert not calibrate.judged("g2c_mlp.train", loose)
    failing = {"program": [{"seed": 1, "gaps": above}], "controls": []}
    assert not calibrate.judged("g2c_mlp.train", failing)
