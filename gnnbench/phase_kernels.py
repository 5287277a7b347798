#!/usr/bin/env python3
"""The device operations of each phase of a cell's train step, from the
program's phase marks (``harness/phases.py``):

    python3 gnnbench/phase_kernels.py --workload <cell> --seed <n> [--steps 30] [--top 8]

Builds the cell as `drivers/train_single.py` does (one card), warms up, profiles
``--steps`` steps, and gives each device operation the phase of the last
mark before its start (forward, backward, optimizer, staging). Prints one
JSON line: per phase, the device milliseconds of its operations a step
(busy time, not the phase's interval) and its ``--top`` operations by
milliseconds a step. Not a benchmark run: no result line, no reference.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--top", type=int, default=8)
    args = parser.parse_args(argv)
    import torch

    from gnnbench.drivers import train_single, training
    from gnnbench.harness import phases, spec

    if not torch.cuda.is_available():
        print("phase_kernels needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    setup = training.RankSetup(cell, args.seed, torch.device("cuda", 0))
    call, _, _ = train_single.compiled_step(setup, args.seed)
    first = training.settle(setup, call, 0, steps=training.CHECKED_STEPS)
    win = training.window(setup, call, first, steps=args.steps, traced=True)
    out = {"workload": cell.name, "steps": win.steps, "device": torch.cuda.get_device_name(0), "phases": {}}
    for phase, ops in zip(phases.PHASES, phases.by_phase(win.trace)):
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:args.top]
        out["phases"][phase] = {"ms_per_step": 1e-6 * sum(ops.values()) / win.steps,
                                "top": [[name[:140], 1e-6 * ns / win.steps] for name, ns in top]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
