"""How ``correct`` is decided for a training cell.

The program's set-up drives its train step, the same object that the
window then runs, through its first three steps on three different
minibatches. Read from it: each step's loss, the norm of each parameter's
first gradient as Adam received it (worked out from Adam's first moment
after one step: m = (1 - beta1) g), and the norm of each parameter's change
over the three steps, read before the fourth. The plain reference follows
the same three steps from the same weights, minibatches and dropout seeds.

The numbers that ``limits/<cell>.json`` names are compared, each against
its limit:

* ``loss_gap``: the largest |program loss - reference loss| / |reference
  loss| over the three steps; ``loss1_gap``: the same of the first step
  alone, for a cell whose later steps' losses swing with round-off that
  Adam's first updates amplify;
* ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norms of the first gradient, over the larger of the
  reference's norm of that leaf and of the median leaf; ``grad_gap_median``:
  the median of those gaps over the leaves, for a cell whose largest gap is
  the round-off of one small leaf;
* ``grad_diff_gap`` and ``grad_diff_median``: the largest and the median,
  over the leaves, of the norm of the difference between the program's and
  the reference's first gradient, over the same denominator; a precision
  lower than the program's moves every element, which the norms average
  out (read where one rank holds the whole gradient);
* ``change_gap``: the same of the change over three steps, leaving out the
  leaves whose reference gradient is below a thousandth of the median
  leaf's (Adam moves them by round-off alone).
"""
from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, Iterable, List, Tuple

from . import spec

NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "grad_gap_median", "grad_diff_gap", "grad_diff_median", "change_gap")
NEGLIGIBLE_GRADIENT = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: Iterable[str]) -> List[float]:
    keep = list(keep)
    med = statistics.median(ref[k] for k in keep)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep]


def gaps(prog: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    ref_grad = ref["grad_norms"]
    names = list(ref_grad)
    if set(prog["grad_norms"]) != set(names) or set(prog["change_norms"]) != set(names):
        return {k: float("inf") for k in NUMBERS}
    med = statistics.median(ref_grad.values())
    moved = [k for k in names if ref_grad[k] >= NEGLIGIBLE_GRADIENT * med]
    grads = _leaf_gaps(prog["grad_norms"], ref_grad, names)
    out = {
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "grad_gap": max(grads),
        "grad_gap_median": statistics.median(grads),
        "change_gap": max(_leaf_gaps(prog["change_norms"], ref["change_norms"], moved)),
    }
    if "grads" in prog and "grads" in ref:  # one rank holds the whole first gradient
        diffs = [float((prog["grads"][k] - ref["grads"][k]).norm()) / max(ref_grad[k], med, 1e-30) for k in names]
        out.update(grad_diff_gap=max(diffs), grad_diff_median=statistics.median(diffs))
    return out


def limits(cell: str) -> Dict[str, float]:
    with open(spec.BENCH_DIR / "limits" / f"{cell}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def judge(found: Dict[str, float], cell_limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": float(found[k]), "limit": cell_limits[k]} for k in cell_limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())  # NaN fails
    return ok, checks


def print_checks(checks: Dict[str, Dict[str, float]]) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()


def program_first_gradients(optimizer, module, beta1: float) -> Dict[str, float]:
    """name -> norm of the first gradient, from Adam's first moment after
    one step, for every parameter whose state this process holds (under
    ZeRO-1, its shard)."""
    inner = getattr(optimizer, "optim", optimizer)
    out = {}
    for name, p in module.named_parameters():
        state = inner.state.get(p)
        if state and "exp_avg" in state:
            out[name] = float(state["exp_avg"].norm()) / (1.0 - beta1)
    return out


def program_first_gradient_tensors(optimizer, module, beta1: float) -> Dict[str, object]:
    """name -> the first gradient itself (on the host), from Adam's first
    moment after one step."""
    inner = getattr(optimizer, "optim", optimizer)
    return {name: (inner.state[p]["exp_avg"].detach().float() / (1.0 - beta1)).cpu()
            for name, p in module.named_parameters() if "exp_avg" in inner.state.get(p, {})}


def program_changes(module, weights0) -> Dict[str, float]:
    return {name: float((p.detach().float() - weights0[name]).norm()) for name, p in module.named_parameters()}


def reference_readings(config, meta_graphs, steps: List[List[Tuple[List[dict], int, float]]], weights0, device,
                       fmt: str = "fp32", fault: str = "") -> Dict[str, object]:
    """The plain reference's readings over ``steps``: each a list of one
    (graphs, dropout seed, weight) a rank. ``fmt`` is a control's lower
    precision; ``fault`` plants one: "half" (half of each batch left out of
    the mean), "no_exchange" (rank 0's gradient alone) or "frozen" (the
    parameters never updated)."""
    from ..reference import common

    ref = spec.reference(config["name"])
    ctx = ref.Context(config, meta_graphs)
    plan = []
    for ranks in steps:
        if fault == "no_exchange":
            ranks = ranks[:1]
        entries = []
        for graphs, seed, weight in ranks:
            batch = ref.Batch(ctx, graphs, device)
            entries.append(((lambda params, b=batch, s=seed: ref.loss(ctx, b, params, s, fmt, fault == "half")),
                            weight))
        plan.append(entries)
    with common.exact_float32():
        return common.train_readings(weights0, plan, config["optimizer"], frozen=fault == "frozen")
