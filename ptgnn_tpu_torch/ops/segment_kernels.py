"""Block-local segment reductions and receiver broadcasts over the batch's
unified edge layout, with hand-written CUDA kernels for Hopper.

The counterpart of the JAX package's ``ops/pallas/segment_kernels.py``. The
batcher lays edges out so that every tile of slots targets one row block of
``R`` receiver rows, with receivers sorted inside each (type-pure) tile; an
``AggregationPlan`` views that layout at edge-tile granularity
(:func:`plan_from_adjacency`, for the extremum) or at supertile granularity
(:func:`sum_plan_from_adjacency`, for sums and the broadcast).

Each kernel has a plain PyTorch version in this module and a launch counter
on its wrapper (``<wrapper>.launches``). A wrapper runs the plain version
for a tensor on the CPU and the kernel for a tensor on a CUDA device; it
never falls back from one to the other.

Kernels (sources in ``ptgnn_tpu_torch/csrc/``):

* ``segment_sum.cu`` replaces ``_sum_kernel``;
* ``segment_extremum.cu`` replaces ``_extremum_kernel``;
* ``broadcast_rows.cu`` replaces ``_broadcast_kernel``.

Gradients mirror the JAX package's custom VJPs as ``torch.autograd.Function``s:
the sum's backward is the broadcast, the broadcast's backward is the sum, and
the extremum's backward splits the cotangent among tied extrema through one
widened broadcast, a sum and a broadcast.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch

from ptgnn_tpu_torch.ops import cuda_build
from ptgnn_tpu_torch.ops.typed_linear import typed_matmul_kernel

_BIG = 3.0e38  # finite stand-in for +/- inf (f32 max ~3.4e38)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SUM_COLS = 32  # columns per CTA of the sum kernel


class AggregationPlan(NamedTuple):
    """Identity-order view of the unified layout: slot e belongs to tile
    e // tile, which targets row block ``tile_row_blocks[e // tile]``; its
    receiver is that block's row ``local_rows[e]`` (R = padding sentinel).
    R = counts.shape[1]; tile = local_rows.numel() // tile_row_blocks.numel()."""

    local_rows: torch.Tensor  # [E_pad] int32 in [0, R]
    tile_row_blocks: torch.Tensor  # [num_tiles] int32, non-decreasing
    counts: torch.Tensor  # [num_row_blocks, R] int32 in-degrees

    @property
    def tile(self) -> int:
        return self.local_rows.shape[0] // self.tile_row_blocks.shape[0]


def plan_from_adjacency(adj) -> AggregationPlan:
    """The layout at edge-tile granularity (type-pure, receiver-sorted tiles,
    as the extremum kernel needs)."""
    return AggregationPlan(adj.local_rows, adj.tile_row_blocks, adj.agg_counts)


def sum_plan_from_adjacency(adj) -> AggregationPlan:
    """The layout at supertile granularity when the batcher aligned row-block
    runs (fewer, larger tiles; only one row block per tile is needed), else
    at edge-tile granularity."""
    if adj.super_tile_row_blocks is None:
        return plan_from_adjacency(adj)
    return AggregationPlan(adj.local_rows, adj.super_tile_row_blocks, adj.agg_counts)


def plan_rows(plan: AggregationPlan, num_rows: int) -> torch.Tensor:
    """[E_pad] int64 global row of each slot; ``num_rows`` (out of range) at
    sentinel slots."""
    r = plan.counts.shape[1]
    lr = plan.local_rows.long()
    rb = plan.tile_row_blocks.long().repeat_interleave(plan.tile)
    real = (lr >= 0) & (lr < r)
    return torch.where(real, rb * r + lr, torch.full_like(lr, num_rows))


def _check_plan(plan: AggregationPlan, device: torch.device) -> None:
    for name, t in zip(plan._fields, plan):
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"plan.{name} must be a contiguous int32 tensor on {device}")
    if plan.local_rows.shape[0] % plan.tile_row_blocks.shape[0]:
        raise ValueError("plan slots are not a whole number of tiles")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for a tensor on {t.device}")


# ---------------------------------------------------------------------------
# Receiver broadcast (replaces _broadcast_kernel)
# ---------------------------------------------------------------------------


def masked_take_rows(table: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """table[rows] with 0 at out-of-range rows."""
    valid = (rows >= 0) & (rows < num_rows)
    safe = torch.where(valid, rows, torch.zeros_like(rows)).long()
    out = table.index_select(0, safe)
    return torch.where(valid[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def broadcast_plain(table: torch.Tensor, plan: AggregationPlan) -> torch.Tensor:
    """Plain version of the broadcast kernel: the plan's row of every slot,
    0 at sentinel slots and at rows past the table."""
    n = table.shape[0]
    return masked_take_rows(table, plan_rows(plan, n), n)


def planned_broadcast_to_edges(table: torch.Tensor, plan: AggregationPlan) -> torch.Tensor:
    """[N, D] node table -> [E_pad, D] per-slot receiver rows in plan order,
    0 at padding slots. CPU: the plain version; CUDA: the kernel."""
    if table.device.type == "cpu":
        return broadcast_plain(table, plan)
    _require_cuda(table, "planned_broadcast_to_edges")
    _check_plan(plan, table.device)
    if table.ndim != 2 or 16 % table.element_size():
        raise ValueError("the broadcast table must be an [N, D] tensor of 1, 2, 4, 8 or 16-byte elements")
    d = table.shape[1]
    per_unit = 16 // table.element_size()
    width = -(-d // per_unit) * per_unit
    if width != d or not table.is_contiguous() or table.data_ptr() % 16:
        # The kernel moves whole 16-byte units: other rows ride in a
        # zero-padded, aligned copy (off the main path, whose rows are whole).
        padded = table.new_zeros((table.shape[0], max(width, per_unit)))
        padded[:, :d] = table
        return planned_broadcast_to_edges(padded, plan)[:, :d]
    e_pad = plan.local_rows.shape[0]
    out = torch.empty((e_pad, d), dtype=table.dtype, device=table.device)
    fn = cuda_build.kernel_function("broadcast")
    err = fn(
        table.data_ptr(), plan.local_rows.data_ptr(), plan.tile_row_blocks.data_ptr(),
        out.data_ptr(), e_pad, d * table.element_size(), plan.tile, plan.counts.shape[1],
        table.shape[0], _stream(table.device),
    )
    cuda_build.check("broadcast", err)
    planned_broadcast_to_edges.launches += 1
    return out


planned_broadcast_to_edges.launches = 0


def adjacency_broadcast_to_edges(table: torch.Tensor, adj) -> torch.Tensor:
    """table[adj.receivers] over the batch's unified layout, 0 at padding
    slots, through the broadcast on the supertile plan."""
    return planned_broadcast_to_edges(table, sum_plan_from_adjacency(adj))


# ---------------------------------------------------------------------------
# Segment extremum (replaces _extremum_kernel)
# ---------------------------------------------------------------------------


def segment_extremum_plain(
    data: torch.Tensor, plan: AggregationPlan, num_nodes: int, is_max: bool
) -> torch.Tensor:
    """Plain version of the extremum kernel: float32 max/min per plan row,
    starting from -+3e38; empty or degenerate (|v| >= 1.5e38) rows -> 0;
    + 0.0 so -0.0 reads as +0.0."""
    num_blocks, r = plan.counts.shape
    neutral = -_BIG if is_max else _BIG
    rows = plan_rows(plan, num_blocks * r)
    real = rows < num_blocks * r
    work = torch.where(real[:, None], data.float(), torch.full((), neutral, device=data.device))
    index = torch.where(real, rows, torch.zeros_like(rows))[:, None].expand_as(work)
    out = torch.full((num_blocks * r, data.shape[1]), neutral, dtype=torch.float32, device=data.device)
    out.scatter_reduce_(0, index, work, "amax" if is_max else "amin", include_self=True)
    out = out[:num_nodes]
    counts = plan.counts.reshape(-1)[:num_nodes]
    invalid = (counts[:, None] == 0) | (out.abs() >= _BIG / 2)
    return torch.where(invalid, torch.zeros((), device=out.device), out) + 0.0


def planned_segment_extremum(
    data: torch.Tensor, plan: AggregationPlan, num_nodes: int, is_max: bool = True
) -> torch.Tensor:
    """[E_pad, M] f32/bf16 slot data in plan order (masked slots already at
    the neutral value) -> [num_nodes, M] float32 per-node max/min, 0 for
    empty rows. CPU: the plain version; CUDA: the kernel."""
    if data.device.type == "cpu":
        return segment_extremum_plain(data, plan, num_nodes, is_max)
    _require_cuda(data, "planned_segment_extremum")
    _check_plan(plan, data.device)
    num_blocks, r = plan.counts.shape
    if data.dtype not in _KERNEL_DTYPES or data.ndim != 2 or not data.is_contiguous():
        raise ValueError("extremum data must be a contiguous [E, M] float32/bfloat16 tensor")
    if data.shape[0] != plan.local_rows.shape[0] or num_nodes > num_blocks * r:
        raise ValueError("extremum data and node count do not match the plan")
    block_tile_start = torch.searchsorted(
        plan.tile_row_blocks,
        torch.arange(num_blocks + 1, dtype=torch.int32, device=data.device),
    )
    out = torch.empty((num_nodes, data.shape[1]), dtype=torch.float32, device=data.device)
    fn = cuda_build.kernel_function("extremum")
    err = fn(
        data.data_ptr(), _KERNEL_DTYPES[data.dtype], int(is_max), plan.local_rows.data_ptr(),
        block_tile_start.data_ptr(), plan.counts.data_ptr(), out.data_ptr(), num_nodes,
        num_blocks, plan.tile, r, data.shape[1], _stream(data.device),
    )
    cuda_build.check("extremum", err)
    planned_segment_extremum.launches += 1
    return out


planned_segment_extremum.launches = 0


# ---------------------------------------------------------------------------
# Segment sum (replaces _sum_kernel)
# ---------------------------------------------------------------------------


def segment_sum_plain(data: torch.Tensor, plan: AggregationPlan, num_nodes: int) -> torch.Tensor:
    """Plain version of the sum kernel: float32 sum per plan row; sentinel
    slots add nothing, rows without slots read 0."""
    num_blocks, r = plan.counts.shape
    # Sentinel slots add into one spare row past the plan's rows.
    out = torch.zeros((num_blocks * r + 1, data.shape[1]), dtype=torch.float32, device=data.device)
    out.index_add_(0, plan_rows(plan, num_blocks * r), data.float())
    return out[:num_nodes]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _sum_splits(device: torch.device, num_blocks: int, d: int) -> int:
    """Parts of each row block's tile range, so the sum kernel runs about two
    CTAs per SM: (row blocks x 32-column chunks) alone fill too few SMs at
    the bench layout (32 row blocks)."""
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    ctas = num_blocks * -(-d // _SUM_COLS)
    return max(1, min(8, -(-2 * sms // max(ctas, 1))))


def planned_segment_sum(
    data: torch.Tensor, plan: AggregationPlan, num_nodes: int
) -> torch.Tensor:
    """[E_pad, D] f32/bf16 slot data in plan order (zero at masked slots, or
    masked by the plan's sentinel) -> [num_nodes, D] float32 per-node sums.
    CPU: the plain version; CUDA: the kernel, whose result is the same bits
    on every run."""
    if data.device.type == "cpu":
        return segment_sum_plain(data, plan, num_nodes)
    _require_cuda(data, "planned_segment_sum")
    _check_plan(plan, data.device)
    num_blocks, r = plan.counts.shape
    if data.dtype not in _KERNEL_DTYPES or data.ndim != 2 or not data.is_contiguous():
        raise ValueError("sum data must be a contiguous [E, D] float32/bfloat16 tensor")
    if data.shape[0] != plan.local_rows.shape[0] or num_nodes > num_blocks * r:
        raise ValueError("sum data and node count do not match the plan")
    d = data.shape[1]
    out = torch.empty((num_nodes, d), dtype=torch.float32, device=data.device)
    if d == 0 or num_nodes == 0:
        return out
    splits = _sum_splits(data.device, num_blocks, d)
    partial = (
        torch.empty((splits, num_nodes, d), dtype=torch.float32, device=data.device)
        if splits > 1 else None
    )
    fn = cuda_build.kernel_function("sum")
    err = fn(
        data.data_ptr(), _KERNEL_DTYPES[data.dtype], plan.local_rows.data_ptr(),
        plan.tile_row_blocks.data_ptr(), plan.tile_row_blocks.shape[0],
        None if partial is None else partial.data_ptr(), out.data_ptr(), num_nodes,
        num_blocks, plan.tile, r, d, splits, _stream(data.device),
    )
    cuda_build.check("sum", err)
    planned_segment_sum.launches += 1
    return out


planned_segment_sum.launches = 0


# ---------------------------------------------------------------------------
# Gradients (the JAX package's custom VJPs)
# ---------------------------------------------------------------------------


def _kernel_dtype(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype in _KERNEL_DTYPES else t.float()


class _SegmentSum(torch.autograd.Function):
    """planned_segment_sum; backward: the broadcast of the cotangent."""

    @staticmethod
    def forward(ctx, data, plan, num_nodes):
        ctx.plan = plan
        ctx.data_dtype = data.dtype
        return planned_segment_sum(data, plan, num_nodes)

    @staticmethod
    def backward(ctx, g):
        return planned_broadcast_to_edges(g.contiguous(), ctx.plan).to(ctx.data_dtype), None, None


class _BroadcastToEdges(torch.autograd.Function):
    """planned_broadcast_to_edges; backward: the segment sum of the cotangent."""

    @staticmethod
    def forward(ctx, table, plan):
        ctx.plan = plan
        ctx.num_rows = table.shape[0]
        return planned_broadcast_to_edges(table, plan)

    @staticmethod
    def backward(ctx, g):
        d_table = planned_segment_sum(_kernel_dtype(g).contiguous(), ctx.plan, ctx.num_rows)
        return d_table.to(g.dtype), None


class _SegmentExtremum(torch.autograd.Function):
    """planned_segment_extremum; backward: the cotangent split evenly among
    the slots that equal their row's extremum (jax segment_max semantics)."""

    @staticmethod
    def forward(ctx, data, plan, num_nodes, is_max):
        out = planned_segment_extremum(data, plan, num_nodes, is_max)
        ctx.save_for_backward(data, out)
        ctx.plan = plan
        ctx.num_nodes = num_nodes
        return out

    @staticmethod
    def backward(ctx, g):
        data, out = ctx.saved_tensors
        d = out.shape[1]
        # One widened broadcast carries the extremum and the cotangent; slots
        # at the sentinel read 0 rows, so their cotangent is 0.
        rows = planned_broadcast_to_edges(torch.cat([out, g.to(out.dtype)], dim=1), ctx.plan)
        is_ext = (data == rows[:, :d]).float()
        ties = planned_segment_sum(is_ext, ctx.plan, ctx.num_nodes)
        ties_per_edge = planned_broadcast_to_edges(ties, ctx.plan).clamp_min(1.0)
        d_data = is_ext * rows[:, d:].to(g.dtype) / ties_per_edge
        return d_data.to(data.dtype), None, None, None


def segment_sum(data: torch.Tensor, plan: AggregationPlan, num_nodes: int) -> torch.Tensor:
    """Differentiable :func:`planned_segment_sum`."""
    return _SegmentSum.apply(data, plan, num_nodes)


def broadcast_to_edges(table: torch.Tensor, plan: AggregationPlan) -> torch.Tensor:
    """Differentiable :func:`planned_broadcast_to_edges`."""
    return _BroadcastToEdges.apply(table, plan)


def segment_extremum(
    data: torch.Tensor, plan: AggregationPlan, num_nodes: int, is_max: bool = True
) -> torch.Tensor:
    """Differentiable :func:`planned_segment_extremum`."""
    return _SegmentExtremum.apply(data, plan, num_nodes, is_max)


# ---------------------------------------------------------------------------
# Public reductions
# ---------------------------------------------------------------------------


def planned_segment_reduce(
    data: torch.Tensor,
    plan: AggregationPlan,
    num_nodes: int,
    reduction: str,
    mask: Optional[torch.Tensor] = None,
    counts_exact: bool = False,
) -> torch.Tensor:
    """torch-scatter-compatible masked reduce over the plan, differentiable;
    accumulates in float32 and casts back to the data's dtype.

    ``counts_exact``: the mask is the batch's static edge mask, so the plan's
    counts are the masked in-degrees and mean skips its counting pass."""
    orig_dtype = data.dtype
    data = _kernel_dtype(data)
    if reduction in ("sum", "add", "mean"):
        if mask is not None:
            data = torch.where(mask[:, None], data, torch.zeros((), dtype=data.dtype, device=data.device))
        out = segment_sum(data.contiguous(), plan, num_nodes)
        if reduction == "mean":
            if mask is None or counts_exact:
                counts = plan.counts.reshape(-1)[:num_nodes].float()
            else:
                counts = planned_segment_sum(mask[:, None].float(), plan, num_nodes)[:, 0]
            out = out / counts.clamp_min(1.0)[:, None]
    elif reduction in ("max", "min"):
        is_max = reduction == "max"
        if data.dtype == torch.bfloat16:
            info = torch.finfo(torch.bfloat16)
            neutral = info.min if is_max else info.max
        else:
            neutral = -_BIG if is_max else _BIG
        if mask is not None:
            data = torch.where(mask[:, None], data, torch.full((), neutral, dtype=data.dtype, device=data.device))
        out = segment_extremum(data.contiguous(), plan, num_nodes, is_max)
    else:
        raise ValueError(f"Unknown reduction '{reduction}'")
    return out.to(orig_dtype)


def adjacency_segment_reduce(
    data: torch.Tensor,
    adj,
    num_nodes: int,
    reduction: str,
    mask: Optional[torch.Tensor] = None,
    counts_exact: bool = False,
) -> torch.Tensor:
    """Masked segment reduce of [E_pad, D] slot data over a batch's unified
    edge layout. Sum/mean use the supertile plan; max/min need the
    receiver-sorted edge tiles."""
    if reduction in ("sum", "add", "mean"):
        plan = sum_plan_from_adjacency(adj)
    else:
        plan = plan_from_adjacency(adj)
    return planned_segment_reduce(data, plan, num_nodes, reduction, mask, counts_exact)


_WRAPPERS = {
    "segment_extremum": planned_segment_extremum,
    "broadcast_to_edges": planned_broadcast_to_edges,
    "segment_sum": planned_segment_sum,
    "typed_matmul": typed_matmul_kernel,
}


def launch_counts() -> Dict[str, int]:
    """The launch counters of the port's kernel wrappers: this module's and
    the typed matmul's (``ops/typed_linear.py``)."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
