"""One card: the program's compiled train step (``core/trainer.TrainStep``:
forward, backward, the global-norm clip and Adam, as one CUDA graph)
over the pool of device-resident minibatches, dispatched ahead with no
per-step sync."""
from __future__ import annotations

import time
from typing import Any, Dict

from ..harness import pool
from . import training


def compiled_step(setup: training.RankSetup, seed: int):
    """(the step's call by index, its optimizer, the TrainStep): Adam with
    the configuration's rate, the clip, AMP where the configuration states
    it; each step's dropout seeded from (seed, index)."""
    import torch

    from ptgnn_tpu_torch.core.trainer import TrainStep

    opt_cfg = setup.config["optimizer"]
    optimizer = torch.optim.Adam(setup.module.parameters(), lr=opt_cfg["learning_rate"],
                                 betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"])
    step = TrainStep(setup.module, optimizer, clip_gradient_norm=opt_cfg["clip_gradient_norm"],
                     amp=setup.config["precision"]["amp"])

    def call(i: int):
        step.generator.manual_seed(pool.dropout_seed(seed, i, 0))
        return step.step(setup.batch(i))[0]

    return call, optimizer, step


def run(cell, args, started: float, device) -> Dict[str, Any]:
    import torch

    setup = training.RankSetup(cell, args.seed, device)
    call, optimizer, step = compiled_step(setup, args.seed)
    program = training.checked_steps(setup, call, optimizer)
    first = training.settle(setup, call, training.CHECKED_STEPS, seconds=training.SETTLE_SECONDS)
    setup_s = time.time() - started
    seconds = min(args.seconds, training.TRACE_SECONDS) if args.trace else args.seconds
    win = training.window(setup, call, first, seconds=seconds, traced=bool(args.trace))
    captures = [s.seconds for s in step.train_step.stats()]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    weights0 = setup.weights0
    groups = setup.stats(win.first_index, win.steps)
    step.clear()
    del step, optimizer, call
    setup.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = training.reference_readings(cell, args.seed, weights0, device)
    return {
        "setup_s": setup_s,
        "windows": [win],
        "groups": [groups],
        "captures_s": [sum(captures)],
        "counters": [win.counters],
        "peak_bytes": peak,
        "shapes": {name: tuple(t.shape) for name, t in weights0.items()},
        "program": program,
        "reference": ref,
        "reference_s": time.perf_counter() - t_ref,
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "forbidden": [],
    }
