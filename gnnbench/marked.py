#!/usr/bin/env python3
"""A run of the benchmark with the program's phase marks forced on and no
profiler, for what tracing costs when it is on:

    python3 gnnbench/marked.py --workload <cell> --seed <n> --seconds <s> --trace 0

Turns marking on (``ptgnn_tpu_torch.utils.tracing.set_marking``) before
``gnnbench/run.py`` starts, so every compiled train step captures its marks
enabled and runs them; otherwise the run is ``run.py``'s, with the same
arguments and result line.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gnnbench import run  # noqa: E402
from ptgnn_tpu_torch.utils import tracing  # noqa: E402

if __name__ == "__main__":
    tracing.set_marking(True)
    sys.exit(run.main())
