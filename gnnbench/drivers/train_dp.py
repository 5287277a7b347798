"""Several cards: ``parallel/dp.py``'s ``DataParallel`` with ZeRO-1 and its
compiled train step (the step ``DistributedModelTrainer`` runs: forward and
backward through DDP's bucketed all-reduce, the clip, the sharded Adam and
its broadcasts, as one CUDA graph), one spawned process a card over NCCL,
each rank cycling its own pool of minibatches, weighted by their graphs.

The ranks run the same number of steps, since every step's collectives
need all of them: rank 0 times a few steps after the checked ones and
fixes the window's count from the pace. The parent only spawns, waits and
joins the ranks' records; it uses no card.
"""
from __future__ import annotations

import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List

from ..harness import imports, pool, spec
from . import training

PACE_STEPS = 20
JOIN_S = 1150.0  # the first run of a checkout builds the kernels


def _rank(rank: int, world: int, target, args: Dict[str, Any], tmp: str) -> None:
    """One spawned rank: joins the group and writes ``target``'s record, or
    its error."""
    try:
        import importlib

        from ptgnn_tpu_torch.parallel import initialize_multi_host

        if args.get("rank_hook"):  # the CPU tests' "module:function", called in each rank first
            module_name, fn = args["rank_hook"].split(":")
            getattr(importlib.import_module(module_name), fn)()
        backend = "gloo" if args.get("device") == "cpu" else "nccl"  # the CPU tests' ranks: gloo
        initialize_multi_host(backend, f"file://{tmp}/store", world, rank)
        record = target(rank, world, args)
        with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(record, f)
    except BaseException:
        (Path(tmp) / f"error{rank}.txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def spawn(world: int, target, args: Dict[str, Any], deadline: float) -> List[Any]:
    """``target(rank, world, args)`` in ``world`` spawned processes, joined
    in a process group (its rendezvous under ``TMPDIR``); the ranks'
    records, or an error with every rank's trace. A rank still running at
    ``deadline`` is killed."""
    import multiprocessing

    tmp = tempfile.mkdtemp(prefix="gnnbench-ranks-", dir=os.environ.get("TMPDIR"))
    try:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, world, target, args, tmp)) for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(deadline - time.time(), 1.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = [(Path(tmp) / f"error{r}.txt").read_text() for r in range(world)
                  if (Path(tmp) / f"error{r}.txt").exists()]
        if errors or any(p.exitcode for p in procs):
            raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errors))
        records = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                records.append(pickle.load(f))
        return records
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def data_parallel_step(setup: training.RankSetup, seed: int, rank: int):
    """(the step's call by index, the ZeRO-1 optimizer, the DataParallel,
    the join of the ranks' first-gradient norms): each rank's minibatch
    weighted by its graphs, its dropout seeded from (seed, index, rank)."""
    import torch
    import torch.distributed as dist

    from ptgnn_tpu_torch.parallel.dp import DataParallel, zero1_optimizer

    opt_cfg = setup.config["optimizer"]
    dp = DataParallel(setup.module, enable_amp=setup.config["precision"]["amp"])
    optimizer = zero1_optimizer(setup.module.parameters(), lambda ps: torch.optim.Adam(
        ps, lr=opt_cfg["learning_rate"], betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"]))
    base_lrs = [opt_cfg["learning_rate"]] * len(optimizer.param_groups)

    def call(i: int):
        dp.generator.manual_seed(pool.dropout_seed(seed, i, rank))
        loss, _ = dp.train_step(setup.batch(i), setup.group(i).weight, None, optimizer, base_lrs,
                                clip_gradient_norm=opt_cfg["clip_gradient_norm"])
        return loss

    names = [n for n, _ in setup.module.named_parameters()]

    def gather(grads):
        squares = torch.tensor([grads.get(n, 0.0) ** 2 for n in names], dtype=torch.float64, device=setup.device)
        dist.all_reduce(squares)
        return {n: math.sqrt(float(x)) for n, x in zip(names, squares.tolist())}

    return call, optimizer, dp, gather


def _rank_run(rank: int, world: int, args: Dict[str, Any]):
    import torch
    import torch.distributed as dist

    cell = args.get("cell") or spec.cell(args["workload"])
    seed, traced, started = args["seed"], bool(args["trace"]), args["started"]
    cpu = args.get("device") == "cpu"
    device = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())

    def sync():
        if not cpu:
            torch.cuda.synchronize(device)

    setup = training.RankSetup(cell, seed, device, rank)
    call, optimizer, dp, gather = data_parallel_step(setup, seed, rank)
    program = training.checked_steps(setup, call, optimizer, gather)
    # The pace: rank 0 times a few steps and fixes the window's count.
    sync()
    t0 = time.perf_counter()
    for i in range(training.CHECKED_STEPS, training.CHECKED_STEPS + PACE_STEPS):
        call(i)
    sync()
    per_step = (time.perf_counter() - t0) / PACE_STEPS
    seconds = min(args["seconds"], training.TRACE_SECONDS) if traced else args["seconds"]
    counts = torch.tensor([max(1, math.ceil(training.SETTLE_SECONDS / per_step)),
                           max(1, math.ceil(seconds / per_step))], device=device)
    dist.broadcast(counts, 0)
    first = training.settle(setup, call, training.CHECKED_STEPS + PACE_STEPS, steps=int(counts[0]))
    count = counts[1]
    before = dp.allreduce_bytes
    setup_s = time.time() - started
    win = training.window(setup, call, first, steps=int(count.item()), traced=traced)
    counters = dict(win.counters, allreduce_bytes=dp.allreduce_bytes - before)
    peak = 0 if cpu else torch.cuda.max_memory_allocated(device)
    captures = sum(s.seconds for s in dp.train_step_compiled.stats())
    weights0 = setup.weights0
    record = {
        "setup_s": setup_s, "window": win, "groups": setup.stats(win.first_index, win.steps),
        "captures_s": captures, "counters": counters, "peak_bytes": peak,
        "shapes": {n: tuple(t.shape) for n, t in weights0.items()},
        "device_kind": "cpu" if cpu else torch.cuda.get_device_name(device),
    }
    dp.clear()
    del dp, optimizer, call
    setup.free()
    sync()
    dist.barrier()
    dist.destroy_process_group()
    if not cpu:
        torch.cuda.empty_cache()
    if rank == 0:
        t_ref = time.perf_counter()
        record["program"] = program
        record["reference"] = training.reference_readings(cell, seed, weights0, device, ranks=world)
        record["reference_s"] = time.perf_counter() - t_ref
    record["forbidden"] = imports.forbidden_loaded()
    return record


def run(cell, args, started: float, device) -> Dict[str, Any]:
    records = spawn(cell.ranks, _rank_run, dict(vars(args), workload=cell.name, started=started),
                    started + JOIN_S)
    head = records[0]
    return {
        "setup_s": max(r["setup_s"] for r in records),
        "windows": [r["window"] for r in records],
        "groups": [r["groups"] for r in records],
        "captures_s": [r["captures_s"] for r in records],
        "counters": [r["counters"] for r in records],
        "peak_bytes": max(r["peak_bytes"] for r in records),
        "shapes": head["shapes"],
        "program": head["program"],
        "reference": head["reference"],
        "reference_s": head["reference_s"],
        "device_kind": head["device_kind"],
        "forbidden": sorted({m for r in records for m in r["forbidden"]}),
    }
