#!/usr/bin/env python3
"""The device operations of each part of a Graph2Seq train step, from the
program's phase and layer marks (``harness/phases.py``,
``harness/layer_marks.py``):

    python3 gnnbench/layer_kernels.py --workload g2s.train --seed <n> [--steps 20] [--top 8]

Builds the cell as ``drivers/train_single.py`` does (one card), warms up,
profiles ``--steps`` steps, and gives each device operation the part of
the last mark before its start: the encoder's forward (mark 0 to 4), the
decoder's forward (4 to 1), the decoder's backward (1 to 5), the encoder's
backward (5 to 2), the clip and optimizer (2 to 3) and staging (3 to the
next 0); the operations between a keyed pair (6 to 7) go to ``keyed``
instead. Prints one JSON line: per part, the device milliseconds of its
operations a step (busy time), its interval a step, and its ``--top``
operations by milliseconds a step. Not a benchmark run: no result line, no
reference.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PARTS = {0: "encoder_forward", 4: "decoder_forward", 1: "decoder_backward", 5: "encoder_backward",
         2: "optimizer", 3: "staging", 6: "keyed"}


def by_part(tr):
    """Per part, the device ns of each operation name that started after a
    mark of that part and before the next mark (a 7 returns to the part of
    the mark before its 6)."""
    from gnnbench.harness import phases

    found, part, outside = [], None, None
    for name, a, _ in tr.device_ops:
        m = phases.MARK.search(name)
        if not m:
            continue
        i = int(m.group(1))
        if i == 6:
            outside, part = part, "keyed"
        elif i == 7:
            part = outside
        else:
            part = PARTS[i]
        found.append((a, part))
    found.sort()
    starts = [t for t, _ in found]
    out = {p: {} for p in PARTS.values()}
    for name, a, b in tr.device_ops:
        k = bisect.bisect_right(starts, a) - 1
        if k < 0 or found[k][1] is None or phases.MARK.search(name):
            continue
        ops = out[found[k][1]]
        ops[name] = ops.get(name, 0) + (b - a)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", default="g2s.train")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--top", type=int, default=8)
    args = parser.parse_args(argv)
    import torch

    from gnnbench.drivers import train_single, training
    from gnnbench.harness import layer_marks, report, spec

    if not torch.cuda.is_available():
        print("layer_kernels needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    setup = training.RankSetup(cell, args.seed, torch.device("cuda", 0))
    call, _, _ = train_single.compiled_step(setup, args.seed)
    first = training.settle(setup, call, 0, steps=training.CHECKED_STEPS)
    win = training.window(setup, call, first, steps=args.steps, traced=True)
    run = report.LayerRun(cell.config, win.trace, win.steps, [], win.counters, 0.0, 0, {})
    steps = layer_marks.steps(run) or []
    order = [0, 4, 1, 5, 2, 3]
    intervals = {PARTS[i]: layer_marks.mean_ms([s.at[j] - s.at[i] for s in steps]) if steps else None
                 for i, j in zip(order, order[1:])}
    out = {"workload": cell.name, "steps": win.steps, "read": len(steps), "device": torch.cuda.get_device_name(0),
           "intervals_ms": intervals, "keyed_ms": layer_marks.mean_ms([s.keyed_ns for s in steps]) if steps else None,
           "parts": {}}
    for part, ops in by_part(win.trace).items():
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:args.top]
        out["parts"][part] = {"ms_per_step": 1e-6 * sum(ops.values()) / win.steps,
                              "top": [[name[:140], 1e-6 * ns / win.steps] for name, ns in top]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
