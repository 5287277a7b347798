#!/usr/bin/env python3
"""The benchmark of ptgnn_tpu_torch on NVIDIA H100 cards.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: builds the
cell's inputs and weights from the seed, warms up its one batch signature,
measures for ``--seconds`` (with ``--trace 1``, a profiled window of at
most three seconds that gives the per-layer metrics), compares the checked
steps with the plain reference, and prints one JSON line last. Exits
non-zero, printing no result, where the cards the cell asks for are not
there or a JAX module was loaded.
"""
from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
CACHE = ROOT / "gnnbench" / "_cache"
# Every kernel cache in the checkout, at fixed paths (the port's own CUDA
# builds go to ptgnn_tpu_torch/_build/ inside it).
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from gnnbench.harness import correctness, imports, report, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {count}", file=sys.stderr)
        return 2
    driver = spec.driver(cell.traffic["driver"])
    out = driver.run(cell, args, STARTED, torch.device("cuda", 0))
    report.describe(cell, out, args.trace)
    found = sorted(set(imports.forbidden_loaded()) | set(out["forbidden"]))
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    line = report.result(cell, args, out, out["device_kind"])
    correctness.print_checks(line["checks"])
    report.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
