"""The plain references against the program's CPU path at a small size:
the whole run of a cell (set-up, checked steps, window, reference) on the
CPU, in float32."""
import argparse
import time

import pytest
import torch

from gnnbench.drivers import train_single
from gnnbench.harness import correctness, report


def cpu_run(cell, seed=2**31 + 77, **extra):
    args = argparse.Namespace(seed=seed, seconds=0.5, trace=0, **extra)
    return train_single.run(cell, args, time.time(), torch.device("cpu"))


@pytest.mark.parametrize("name", ["g2c_mlp.train", "ppi.train_bf16"])
def test_reference_follows_the_program(small, name):
    cell = small(name)
    cell.config["precision"].update(amp=False, dtype="float32")  # the plain float32 path
    out = cpu_run(cell)
    assert out["program"]["losses"][0] == pytest.approx(out["reference"]["losses"][0], rel=1e-5)
    gaps = correctness.gaps(out["program"], out["reference"])
    # float32 on both sides; Adam's near-sign first updates of nearly-zero
    # gradients let the later steps' losses and the change drift most.
    assert gaps["loss1_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4, gaps
    assert gaps["loss_gap"] < 5e-3 and gaps["change_gap"] < 5e-2, gaps
    assert out["windows"][0].steps >= 1 and out["windows"][0].edges > 0
    report.describe(cell, out, 0)
    line = report.result(cell, argparse.Namespace(trace=0), out, out["device_kind"])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"train_edges_per_s", "train_step_p95_ms", "setup_s"}
    assert set(line["checks"]) == set(correctness.limits(name))
