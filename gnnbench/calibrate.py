#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 gnnbench/calibrate.py --workload <cell> --seeds 11,12,... [--control-seeds 3] [--out FILE]

For every seed of ``--seeds``: the program's three checked steps at the
cell's own sizes (a pool of three minibatches; the same set-up, step and
reference as a run of ``run.py``) and the gaps to the reference. For the
first ``--control-seeds`` seeds: the control (the reference at the
precision below the configuration's, in the program's place) and the
planted faults (half of each batch left out of the mean; the parameters
never updated; on several ranks, rank 0's gradient alone), each against
the reference. Where the cell has its limits, each reading is judged
against them as a run judges its own, and the exit code is 1 unless every
program seed comes out correct and every control and fault not correct.
``--controls-only`` skips the program. A run of the benchmark does not
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def control_readings(cell, seed: int, device, ranks: int):
    """{name: gaps} of the control and the faults against the reference."""
    import torch

    from gnnbench.drivers import training
    from gnnbench.harness import correctness, pool, spec, weights

    task = spec.task(cell.config["task"])
    meta = pool.metadata_graphs(cell.traffic, seed)
    _, module = task.build(cell.config, meta, torch.device("cpu"))
    w0 = weights.make(module, seed, device)
    ref = training.reference_readings(cell, seed, w0, device, ranks)
    out = {}
    kinds = [("control_" + CONTROL[cell.config["precision"]["dtype"]], CONTROL[cell.config["precision"]["dtype"]], ""),
             ("fault_half", "fp32", "half"), ("fault_frozen", "fp32", "frozen")]
    if ranks > 1:
        kinds.append(("fault_no_exchange", "fp32", "no_exchange"))
    for name, fmt, fault in kinds:
        other = training.reference_readings(cell, seed, w0, device, ranks, fmt=fmt, fault=fault)
        out[name] = correctness.gaps(other, ref)
    return out


def single_program(cell, seed: int, device):
    from gnnbench.drivers import train_single, training
    from gnnbench.harness import correctness

    setup = training.RankSetup(cell, seed, device)
    call, optimizer, step = train_single.compiled_step(setup, seed)
    program = training.checked_steps(setup, call, optimizer)
    w0 = setup.weights0
    step.clear()
    setup.free()
    ref = training.reference_readings(cell, seed, w0, device)
    return correctness.gaps(program, ref), program["losses"], ref["losses"], worst_leaves(program, ref)


def worst_leaves(program, ref, top: int = 4):
    """The leaves of the largest gaps, with both sides' norms."""
    out = {}
    for key in ("grad_norms", "change_norms"):
        p, r = program[key], ref[key]
        gaps = sorted(((abs(p[k] - r[k]) / max(r[k], 1e-30), k, p[k], r[k]) for k in r), reverse=True)[:top]
        out[key] = [[k, g, pv, rv] for g, k, pv, rv in gaps]
    return out


def _dp_rank(rank: int, world: int, args):
    """One rank of a multi-rank cell: every seed's checked steps; rank 0
    adds the reference, then the control and the faults."""
    import torch
    import torch.distributed as dist

    from gnnbench.drivers import train_dp, training
    from gnnbench.harness import correctness

    cell, seeds = args["cell"], args["seeds"]
    device = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for seed in seeds:
        setup = training.RankSetup(cell, seed, device, rank)
        call, optimizer, dp, gather = train_dp.data_parallel_step(setup, seed, rank)
        program = training.checked_steps(setup, call, optimizer, gather)
        w0 = setup.weights0
        dp.clear()
        del dp, optimizer, call
        setup.free()
        if rank == 0:
            ref = training.reference_readings(cell, seed, w0, device, ranks=world)
            rows.append({"seed": seed, "gaps": correctness.gaps(program, ref), "losses": program["losses"],
                         "reference_losses": ref["losses"]})
        torch.cuda.synchronize(device)
        dist.barrier()
    dist.destroy_process_group()
    if rank:
        return None
    controls = [{"seed": s, **control_readings(cell, s, device, world)} for s in seeds[:args["control_seeds"]]]
    return {"program": rows, "controls": controls}


def judged(cell_name: str, result) -> bool:
    """Each reading judged against the cell's limits, as a run judges its
    own: every program seed has to come out correct, and every control and
    fault on every seed not correct. Prints each verdict."""
    from gnnbench.harness import correctness

    try:
        cell_limits = correctness.limits(cell_name)
    except FileNotFoundError:
        print(json.dumps({"judged": False, "why": f"no limits/{cell_name}.json yet"}), flush=True)
        return True
    sound = True
    for row in result["program"]:
        ok, _ = correctness.judge(row["gaps"], cell_limits)
        sound &= ok
        print(json.dumps({"seed": row["seed"], "reading": "program", "correct": ok}), flush=True)
    for c in result["controls"]:
        for name, found in c.items():
            if name == "seed":
                continue
            ok, _ = correctness.judge(found, cell_limits)
            sound &= not ok
            print(json.dumps({"seed": c["seed"], "reading": name, "correct": ok}), flush=True)
    print(json.dumps({"judged": True, "limits": cell_limits, "as_required": sound}), flush=True)
    return sound


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--out", default=None)
    parser.add_argument("--controls-only", action="store_true", help="the control and the faults alone")
    args = parser.parse_args()
    import torch

    from gnnbench.drivers import train_dp
    from gnnbench.harness import correctness, spec

    cell = spec.cell(args.workload)
    cell.traffic["pool_batches"] = 3
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.time()
    if cell.ranks == 1:
        device = torch.device("cuda", 0)
        program = []
        for seed in ([] if args.controls_only else seeds):
            g, lp, lr, worst = single_program(cell, seed, device)
            program.append({"seed": seed, "gaps": g, "losses": lp, "reference_losses": lr, "worst": worst})
            print(json.dumps(program[-1]), flush=True)
        controls = [{"seed": s, **control_readings(cell, s, device, 1)} for s in seeds[:args.control_seeds]]
        result = {"program": program, "controls": controls}
    else:
        result = train_dp.spawn(cell.ranks, _dp_rank, {"cell": cell, "seeds": [] if args.controls_only else seeds,
                                                       "control_seeds": args.control_seeds}, t0 + 3000)[0]
    for c in result["controls"]:
        print(json.dumps(c), flush=True)
    numbers = correctness.NUMBERS
    lower = {k: max((r["gaps"].get(k, float("nan")) for r in result["program"]), default=float("nan"))
             for k in numbers}
    upper = {name: {k: min(c[name].get(k, float("nan")) for c in result["controls"]) for k in numbers}
             for name in result["controls"][0] if name != "seed"} if result["controls"] else {}
    result.update(workload=args.workload, lower=lower, upper=upper, seconds=time.time() - t0,
                  card=torch.cuda.get_device_name(0))
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    sound = judged(args.workload, result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(result, as_required=sound), f, indent=1)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
