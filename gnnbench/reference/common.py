"""Plain PyTorch pieces of the references: the flattened edge list, the
MLP message-passing stack, dropout from a seeded generator, the global-norm
clip and Adam, and the training readings that ``correct`` compares.

Everything here is written from the published model (microsoft/ptgnn's MLP
message passing, Adam, ``clip_by_global_norm``) with plain tensor
operations, in float32 with TF32 off. It imports nothing of the program.

``fmt`` selects the precision of every matrix product: "fp32" (the
reference), or the lower precision of a control ("tf32", "fp8"):
both operands rounded to it going forward and the product's cotangent
rounded to it going back, accumulated in float32. fp8 is e4m3 with a
per-tensor scale (amax to 448), as fp8 training scales its operands.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------
def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest even at TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = 448.0 / x.detach().abs().amax().float().clamp_min(1e-30)
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


ROUNDING: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tf32": _round_tf32,
    "fp8": _round_fp8,
}


class _RoundForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        return ROUNDING[fmt](x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ROUNDING[ctx.fmt](g), None


def mm(a: torch.Tensor, b: torch.Tensor, fmt: str = "fp32") -> torch.Tensor:
    if fmt == "fp32":
        return a @ b
    return _RoundBackward.apply(_RoundForward.apply(a, fmt) @ _RoundForward.apply(b, fmt), fmt)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], fmt: str) -> torch.Tensor:
    """x @ weight.T (+ bias), weight ``[out, in]``."""
    y = mm(x, weight.t(), fmt)
    return y if bias is None else y + bias


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------
class Edges:
    """A minibatch's edges, flattened: forward edges of type t, their
    backward copies of type T + t and one self edge a node of type 2T
    (where the configuration asks for them), sorted by type, so each type's
    edges are one run (``runs``: (type, start, end))."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, etype: np.ndarray, num_types: int,
                 device: torch.device):
        order = np.argsort(etype, kind="stable")
        self.src = torch.from_numpy(src[order].astype(np.int64)).to(device)
        self.dst = torch.from_numpy(dst[order].astype(np.int64)).to(device)
        et = etype[order]
        bounds = np.searchsorted(et, np.arange(num_types + 1))
        self.runs = [(t, int(bounds[t]), int(bounds[t + 1])) for t in range(num_types) if bounds[t + 1] > bounds[t]]


def flatten_edges(per_graph: Sequence[Tuple[int, Sequence[Tuple[np.ndarray, np.ndarray]]]], *, backward: bool,
                  self_edges: bool, device: torch.device) -> Tuple[int, Edges]:
    """(node count, Edges) of graphs given as (nodes, [(src, dst) of each
    forward type in order]), numbered one after another."""
    srcs, dsts, types = [], [], []
    offset = 0
    num_fwd = len(per_graph[0][1]) if per_graph else 0
    total_types = num_fwd * (2 if backward else 1) + (1 if self_edges else 0)
    for n, lists in per_graph:
        for t, (s, d) in enumerate(lists):
            s = np.asarray(s, np.int64) + offset
            d = np.asarray(d, np.int64) + offset
            srcs.append(s)
            dsts.append(d)
            types.append(np.full(len(s), t, np.int64))
            if backward:
                srcs.append(d)
                dsts.append(s)
                types.append(np.full(len(s), num_fwd + t, np.int64))
        if self_edges:
            ids = np.arange(offset, offset + n, dtype=np.int64)
            srcs.append(ids)
            dsts.append(ids)
            types.append(np.full(n, total_types - 1, np.int64))
        offset += n
    cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64))
    return offset, Edges(cat(srcs), cat(dsts), cat(types), total_types, device)


# ---------------------------------------------------------------------------
# The message-passing stack
# ---------------------------------------------------------------------------
def dropout(x: torch.Tensor, rate: float, draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """Inverted dropout: keep where a uniform draw is below 1 - rate.
    ``draw(width)`` returns the draws of the real rows."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = draw(x.shape[1]) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def mlp_message_passing(x: torch.Tensor, edges: Edges, params: Dict[str, torch.Tensor], prefix: str,
                        layer_cfg: Dict, fmt: str) -> torch.Tensor:
    """One MLP message-passing layer before its output dropout: a typed
    linear message from the [source, target] states of every edge, reduced
    to its receiver (max or sum), then GELU, LayerNorm, a dense layer and
    tanh."""
    w = params[f"{prefix}.message_mlp.weights_0"]  # [T, Din, M]
    inp = x[edges.src]
    if layer_cfg["target_state_input"]:
        inp = torch.cat([inp, x[edges.dst]], dim=-1)
    msgs = torch.cat([mm(inp[a:b], w[t], fmt) for t, a, b in edges.runs], dim=0)
    n, m = x.shape[0], w.shape[-1]
    index = edges.dst[:, None].expand(-1, m)
    agg = layer_cfg["aggregation"]
    if agg == "max":
        out = torch.zeros((n, m), dtype=msgs.dtype, device=x.device).scatter_reduce(
            0, index, msgs, "amax", include_self=False)
    elif agg == "sum":
        out = torch.zeros((n, m), dtype=msgs.dtype, device=x.device).scatter_add(0, index, msgs)
    else:
        raise ValueError(f"aggregation {agg!r} has no reference")
    out = F.gelu(out, approximate="none") if layer_cfg["message_activation"] == "gelu" else out
    if layer_cfg["layer_norm"]:
        out = F.layer_norm(out, (m,), params[f"{prefix}.layer_norm.weight"], params[f"{prefix}.layer_norm.bias"],
                           eps=1e-5)
    out = linear(out, params[f"{prefix}.dense.weight"], params[f"{prefix}.dense.bias"], fmt)
    return torch.tanh(out) if layer_cfg["dense_activation"] == "tanh" else out


def run_stack(x: torch.Tensor, edges: Edges, params: Dict[str, torch.Tensor], config: Dict,
              draw: Callable[[int], torch.Tensor], fmt: str) -> torch.Tensor:
    """The configuration's stack: residual origins stash the states, a
    ``concat`` or ``mean`` entry combines them with the current ones, and
    every ``mlp_mp`` entry is a layer with its output dropout."""
    layer_cfg = config["mlp_mp"]
    stash: Dict[str, torch.Tensor] = {}
    for i, entry in enumerate(config["stack"]):
        kind = entry[0]
        if kind == "origin":
            stash[entry[1]] = x
        elif kind == "concat":
            x = torch.cat([stash.pop(entry[1]), x], dim=-1)
        elif kind == "mean":
            x = (stash.pop(entry[1]) + x) * 0.5
        elif kind == "mlp_mp":
            x = mlp_message_passing(x, edges, params, f"gnn.message_passing_layers.{i}", layer_cfg, fmt)
            x = dropout(x, layer_cfg["dropout_rate"], draw)
        else:
            raise ValueError(f"stack entry {kind!r} has no reference")
    return x


def dropout_draws(seed: int, rows: int, padded_rows: int, device: torch.device) -> Callable[[int], torch.Tensor]:
    """The dropout draws of one step: a generator on ``device`` seeded with
    ``seed``; each call draws a [padded_rows, width] uniform block, as the
    padded minibatch's layer does, and keeps its real rows."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return lambda width: torch.rand((padded_rows, width), generator=gen, device=device)[:rows]


# ---------------------------------------------------------------------------
# Training and its readings
# ---------------------------------------------------------------------------
LossFn = Callable[[Dict[str, torch.Tensor]], torch.Tensor]


def global_norm_clip(grads: List[torch.Tensor], max_norm: float) -> None:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    if float(norm) >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)


def train_readings(params0: Dict[str, torch.Tensor], steps: Sequence[Sequence[Tuple[LossFn, float]]],
                   optimizer: Dict, frozen: bool = False) -> Dict[str, object]:
    """Train a float32 copy of ``params0`` through ``steps``: each step a
    list of (loss of one rank's minibatch, its weight); the step's gradient
    is the weighted mean of the ranks' gradients, clipped by global norm,
    then one Adam step. Returns each step's weighted mean loss, each leaf's
    first (clipped) gradient and its norm, and the norm of its change over
    the steps.
    ``frozen`` (a planted fault) leaves the parameters as they are."""
    names = list(params0)
    params = {k: params0[k].detach().float().clone().requires_grad_(True) for k in names}
    b1, b2 = optimizer["betas"]
    lr, eps = optimizer["learning_rate"], optimizer["eps"]
    m = {k: torch.zeros_like(params[k]) for k in names}
    v = {k: torch.zeros_like(params[k]) for k in names}
    losses, first_grad = [], None
    for t, ranks in enumerate(steps, start=1):
        total = sum(w for _, w in ranks)
        step_loss = 0.0
        for loss_fn, w in ranks:
            share = w / max(total, 1e-9)
            loss = loss_fn(params)
            (loss * share).backward()
            step_loss += share * float(loss.detach())
        losses.append(step_loss)
        grads = [params[k].grad if params[k].grad is not None else torch.zeros_like(params[k]) for k in names]
        with torch.no_grad():
            global_norm_clip(grads, optimizer["clip_gradient_norm"])
            if first_grad is None:
                first_grad = {k: float(g.norm()) for k, g in zip(names, grads)}
                first_grads = {k: g.detach().float().cpu().clone() for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                params[k].grad = None
                if frozen:
                    continue
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v[k] / (1 - b2 ** t)
                params[k].sub_(lr * m_hat / (v_hat.sqrt() + eps))
    change = {k: float((params[k].detach() - params0[k].float()).norm()) for k in names}
    return {"losses": losses, "grad_norms": first_grad, "grads": first_grads, "change_norms": change}
