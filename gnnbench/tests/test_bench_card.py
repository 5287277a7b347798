"""A short run of each one-card cell on a CUDA card: the result line's
shape and ``correct``. Skips where there is no card."""
import json
import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g2c_mlp.train", "ppi.train_bf16"])
def test_cell_runs_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "gnnbench/run.py", "--workload", name, "--seed", str(2**31 + 9),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
