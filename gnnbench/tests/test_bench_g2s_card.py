"""A short traced run of ``g2s.train`` on a CUDA card: the result line is
correct and holds the four readings of Graph2Seq's layer marks and FLOP
count, each finite, the step's share of the peak between 0 and 100 %.
Skips where there is no card."""
import json
import math
import subprocess
import sys

import pytest

from .conftest import ROOT

READINGS = ("encoder_ms_per_step", "decoder_ms_per_step", "keyed_dropout_ms_per_step", "g2s_step_mfu")


@pytest.mark.cuda
def test_g2s_cell_runs_traced_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "gnnbench/run.py", "--workload", "g2s.train", "--seed", str(2**31 + 9),
                          "--seconds", "1", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(READINGS) <= set(metrics), metrics
    assert all(math.isfinite(metrics[k]) and metrics[k] > 0 for k in READINGS), metrics
    assert metrics["g2s_step_mfu"] < 100
    assert metrics["keyed_dropout_ms_per_step"] < metrics["encoder_ms_per_step"]
