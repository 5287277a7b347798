"""Block-local segment reductions and receiver broadcasts over the batch's
unified edge layout, with hand-written CUDA kernels for Hopper.

The counterpart of the JAX package's ``ops/pallas/segment_kernels.py``. The
batcher lays edges out so that every tile of slots targets one row block of
``R`` receiver rows, with receivers sorted inside each (type-pure) tile; an
``AggregationPlan`` views that layout at edge-tile granularity
(:func:`plan_from_adjacency`, for the extremum) or at supertile granularity
(:func:`sum_plan_from_adjacency`, for sums and the broadcast). A plan from a
batch also carries the batch's row index (``row_offsets``, ``row_slots``:
every row's real slots in increasing order, built once per batch on the
host), over which the extremum and sum kernels reduce row by row; a plan
built by hand gets it from :func:`with_row_index`.

Each kernel has a plain PyTorch version in this module, and its wrapper
counts its launches in the counter table (``utils/tracing.py``) under the
kernel's name (the broadcast keyed by row bytes and dtype; the table's
view is :func:`launch_counts`). A wrapper runs the plain version
for a tensor on the CPU and the kernel for a tensor on a CUDA device; it
never falls back from one to the other.

Kernels (sources in ``ptgnn_tpu_torch/csrc/``):

* ``segment_sum.cu`` replaces ``_sum_kernel``;
* ``segment_extremum.cu`` replaces ``_extremum_kernel``;
* ``segment_extremum_argmax.cu`` replaces ``_extremum_argmax_kernel``;
* ``broadcast_rows.cu`` replaces ``_broadcast_kernel``.

Gradients mirror the JAX package's custom VJPs as ``torch.autograd.Function``s:
the sum's backward is the broadcast, the broadcast's backward is the sum, and
the extremum's backward splits the cotangent among tied extrema through one
widened broadcast, a sum and a broadcast. The argmax-carrying extremum is not
differentiated itself: the fused op routes its cotangents by the winning
slots (``ops/fused_mp.py``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ptgnn_tpu_torch.ops import cuda_build
from ptgnn_tpu_torch.ops.segment import masked_take
from ptgnn_tpu_torch.utils import tracing

_BIG = 3.0e38  # finite stand-in for +/- inf (f32 max ~3.4e38)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Slots of one row that one lane group of the row-indexed kernels folds; a
# longer row is split into pieces at multiples of it. Above every row of the
# bench (14) and PPI (49) layouts.
ROW_CHUNK = 128


class AggregationPlan(NamedTuple):
    """Identity-order view of the unified layout: slot e belongs to tile
    e // tile, which targets row block ``tile_row_blocks[e // tile]``; its
    receiver is that block's row ``local_rows[e]`` (R = padding sentinel).
    R = counts.shape[1]; tile = local_rows.numel() // tile_row_blocks.numel().
    The row index lists row g's real slots as
    ``row_slots[row_offsets[g]:row_offsets[g + 1]]``, in increasing order."""

    local_rows: torch.Tensor  # [E_pad] int32 in [0, R]
    tile_row_blocks: torch.Tensor  # [num_tiles] int32, non-decreasing
    counts: torch.Tensor  # [num_row_blocks, R] int32 in-degrees
    row_offsets: Optional[torch.Tensor] = None  # [num_row_blocks * R + 1] int32
    row_slots: Optional[torch.Tensor] = None  # [E_pad] int32, tail -1

    @property
    def tile(self) -> int:
        return self.local_rows.shape[0] // self.tile_row_blocks.shape[0]


def plan_from_adjacency(adj) -> AggregationPlan:
    """The layout at edge-tile granularity (type-pure, receiver-sorted tiles,
    as the argmax extremum kernel needs), with the batch's row index."""
    return AggregationPlan(adj.local_rows, adj.tile_row_blocks, adj.agg_counts, adj.row_offsets, adj.row_slots)


def sum_plan_from_adjacency(adj) -> AggregationPlan:
    """The layout at supertile granularity when the batcher aligned row-block
    runs (fewer, larger tiles; only one row block per tile is needed), else
    at edge-tile granularity."""
    if adj.super_tile_row_blocks is None:
        return plan_from_adjacency(adj)
    return AggregationPlan(
        adj.local_rows, adj.super_tile_row_blocks, adj.agg_counts, adj.row_offsets, adj.row_slots
    )


def plan_rows(plan: AggregationPlan, num_rows: int) -> torch.Tensor:
    """[E_pad] int64 global row of each slot; ``num_rows`` (out of range) at
    sentinel slots."""
    r = plan.counts.shape[1]
    lr = plan.local_rows.long()
    rb = plan.tile_row_blocks.long().repeat_interleave(plan.tile)
    real = (lr >= 0) & (lr < r)
    return torch.where(real, rb * r + lr, torch.full_like(lr, num_rows))


def with_row_index(plan: AggregationPlan) -> AggregationPlan:
    """``plan`` with its row index, computed here with torch ops where it has
    none (a plan built by hand; a batch's plans carry the index the batcher
    built on the host). The offsets count the plan's real slots per row."""
    if plan.row_offsets is not None and plan.row_slots is not None:
        return plan
    n = plan.counts.numel()
    rows = plan_rows(plan, n)
    ordered, order = torch.sort(rows, stable=True)
    row_slots = torch.where(ordered < n, order, torch.full_like(order, -1)).int()
    # Row i's slots start after every slot of a lower row: a search of the
    # sorted rows, which, unlike a bincount, never waits for the device.
    row_offsets = torch.searchsorted(ordered, torch.arange(n + 1, device=rows.device)).int()
    return plan._replace(row_offsets=row_offsets, row_slots=row_slots)


def _check_plan(plan: AggregationPlan, device: torch.device) -> None:
    for name, t in zip(plan._fields, plan):
        if t is None and name in ("row_offsets", "row_slots"):
            continue
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"plan.{name} must be a contiguous int32 tensor on {device}")
    if plan.local_rows.shape[0] % plan.tile_row_blocks.shape[0]:
        raise ValueError("plan slots are not a whole number of tiles")
    if plan.row_offsets is not None and (
        plan.row_offsets.shape != (plan.counts.numel() + 1,)
        or plan.row_slots is None or plan.row_slots.shape != plan.local_rows.shape
    ):
        raise ValueError("the plan's row index does not match its slots and rows")


# Every launch runs under its tensors' device guard (``torch.cuda.device``):
# the CUDA runtime launches on the calling thread's current device, and the
# kernels read that device's SM count and keep per-device state, so a rank
# or thread whose current device is another card still launches on the
# tensors' own.
def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for a tensor on {t.device}")


# ---------------------------------------------------------------------------
# Receiver broadcast (replaces _broadcast_kernel)
# ---------------------------------------------------------------------------


def broadcast_plain(table: torch.Tensor, plan: AggregationPlan) -> torch.Tensor:
    """Plain version of the broadcast kernel: the plan's row of every slot,
    0 at sentinel slots and at rows past the table."""
    n = table.shape[0]
    return masked_take(table, plan_rows(plan, n), 0.0)


def planned_broadcast_to_edges(table: torch.Tensor, plan: AggregationPlan) -> torch.Tensor:
    """[N, D] node table -> [E_pad, D] per-slot receiver rows in plan order,
    0 at padding slots. CPU: the plain version; CUDA: the kernel, for rows
    of any width in whole elements (a non-contiguous table is made
    contiguous; a table whose address or rows are not whole 16-byte vectors
    goes by the kernel's narrow route)."""
    if table.device.type == "cpu":
        return broadcast_plain(table, plan)
    _require_cuda(table, "planned_broadcast_to_edges")
    with torch.cuda.device(table.device):
        _check_plan(plan, table.device)
        if table.ndim != 2 or 16 % table.element_size() or table.data_ptr() % table.element_size():
            raise ValueError("the broadcast table must be an [N, D] tensor of aligned 1, 2, 4, 8 or 16-byte "
                             "elements")
        e_pad = plan.local_rows.shape[0]
        if max(e_pad, table.shape[0], plan.counts.numel()) >= 2**31:
            raise ValueError("the broadcast kernel counts slots and rows in 32 bits")
        table = table.contiguous()
        d = table.shape[1]
        out = torch.empty((e_pad, d), dtype=table.dtype, device=table.device)
        fn = cuda_build.kernel_function("broadcast")
        err = fn(
            table.data_ptr(), plan.local_rows.data_ptr(), plan.tile_row_blocks.data_ptr(),
            out.data_ptr(), e_pad, d * table.element_size(), plan.tile, plan.counts.shape[1],
            table.shape[0], _stream(table.device),
        )
        cuda_build.check("broadcast", err)
    tracing.count("broadcast_to_edges", (d * table.element_size(), str(table.dtype).removeprefix("torch.")))
    return out


def adjacency_broadcast_to_edges(table: torch.Tensor, adj) -> torch.Tensor:
    """table[adj.receivers] over the batch's unified layout, 0 at padding
    slots, through the broadcast on the supertile plan."""
    return planned_broadcast_to_edges(table, sum_plan_from_adjacency(adj))


# ---------------------------------------------------------------------------
# The row-indexed reductions: segment extremum and segment sum
# ---------------------------------------------------------------------------


def _row_reduce_setup(
    data: torch.Tensor, plan: AggregationPlan, num_nodes: int, what: str
) -> Tuple[AggregationPlan, torch.Tensor]:
    """Checks the arguments of a row-indexed kernel; returns the plan with
    its row index and the [num_nodes, D] float32 output."""
    _check_plan(plan, data.device)
    num_blocks, r = plan.counts.shape
    if data.dtype not in _KERNEL_DTYPES or data.ndim != 2 or not data.is_contiguous():
        raise ValueError(f"{what} data must be a contiguous [E, D] float32/bfloat16 tensor")
    if data.shape[0] != plan.local_rows.shape[0] or num_nodes > num_blocks * r:
        raise ValueError(f"{what} data and node count do not match the plan")
    out = torch.empty((num_nodes, data.shape[1]), dtype=torch.float32, device=data.device)
    return with_row_index(plan), out


_SCRATCH: Dict[Tuple[Optional[int], str], torch.Tensor] = {}
_RETIRED: List[torch.Tensor] = []


def _scratch(device: torch.device, name: str, size: int, dtype: torch.dtype) -> torch.Tensor:
    """A per-device buffer of at least ``size`` elements, shared by the
    launches on the device's stream (allocated under the launch's device
    guard, on ``device`` itself). Grown, never shrunk; a replaced buffer
    stays alive, since a captured CUDA graph may still point at it. New
    buffers are zero (the kernels leave their counters at 0)."""
    key = (device.index, name)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < size:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the row reductions' scratch must grow before a CUDA graph capture")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(size, 2 * (0 if buf is None else buf.numel())), dtype=dtype, device=device)
        _SCRATCH[key] = buf
    return buf


def _row_reduce_scratch(data: torch.Tensor, num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 partials (a head and a body piece per ROW_CHUNK window of
    slots) and the int32 counters (one per row and column chunk of at least
    32 columns) of the rows that the kernels split."""
    windows = -(-data.shape[0] // ROW_CHUNK)
    partials = _scratch(data.device, "partials", 2 * windows * data.shape[1], torch.float32)
    counters = _scratch(data.device, "counters", num_nodes * -(-data.shape[1] // 32), torch.int32)
    return partials, counters


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
    with torch.cuda.device(data.device):
        plan, out = _row_reduce_setup(data, plan, num_nodes, "extremum")
        if out.numel() == 0:
            return out
        partials, counters = _row_reduce_scratch(data, num_nodes)
        fn = cuda_build.kernel_function("extremum")
        err = fn(
            data.data_ptr(), _KERNEL_DTYPES[data.dtype], int(is_max), plan.row_offsets.data_ptr(),
            plan.row_slots.data_ptr(), plan.local_rows.data_ptr(), plan.tile_row_blocks.data_ptr(),
            plan.counts.data_ptr(), out.data_ptr(), partials.data_ptr(), partials.numel(),
            counters.data_ptr(), counters.numel(), num_nodes, data.shape[0], plan.tile,
            plan.counts.shape[1], data.shape[1], ROW_CHUNK, _stream(data.device),
        )
        cuda_build.check("extremum", err)
    tracing.count("segment_extremum")
    return out


# ---------------------------------------------------------------------------
# Segment extremum with its first winning slot (replaces _extremum_argmax_kernel)
# ---------------------------------------------------------------------------


def segment_extremum_argmax_plain(
    data: torch.Tensor, plan: AggregationPlan, num_nodes: int, is_max: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the argmax extremum kernel: the float32 max/min per
    plan row (as :func:`segment_extremum_plain`) and, per (row, column), the
    smallest slot id whose value equals it (int32). Rows without slots, or
    whose extremum is degenerate (|v| >= 1.5e38), give value 0 and arg -1;
    -0.0 and +0.0 tie, and the value reads +0.0."""
    num_blocks, r = plan.counts.shape
    neutral = -_BIG if is_max else _BIG
    rows = plan_rows(plan, num_blocks * r)
    real = rows < num_blocks * r
    work = torch.where(real[:, None], data.float(), torch.full((), neutral, device=data.device))
    index = torch.where(real, rows, torch.zeros_like(rows))[:, None].expand_as(work)
    vals = torch.full((num_blocks * r, data.shape[1]), neutral, dtype=torch.float32, device=data.device)
    vals.scatter_reduce_(0, index, work, "amax" if is_max else "amin", include_self=True)
    # The first occurrence: the least slot id among the slots equal to their
    # row's extremum (sentinel and losing slots offer no id).
    slots = torch.arange(data.shape[0], device=data.device)[:, None]
    wins = real[:, None] & (work == vals.gather(0, index))
    offer = torch.where(wins, slots, torch.full((), data.shape[0], device=data.device))
    args = torch.full_like(vals, data.shape[0], dtype=torch.int64)
    args.scatter_reduce_(0, index, offer, "amin", include_self=True)
    vals, args = vals[:num_nodes], args[:num_nodes]
    counts = plan.counts.reshape(-1)[:num_nodes]
    invalid = (counts[:, None] == 0) | (vals.abs() >= _BIG / 2)
    vals = torch.where(invalid, torch.zeros((), device=vals.device), vals) + 0.0
    return vals, torch.where(invalid, torch.full((), -1, device=args.device), args).int()


def planned_segment_extremum_with_argmax(
    data: torch.Tensor, plan: AggregationPlan, num_nodes: int, is_max: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[E_pad, M] f32/bf16 slot data in plan order (masked slots already at
    the neutral value) -> ([num_nodes, M] float32 per-node max/min, [num_nodes,
    M] int32 first winning slot), 0 and -1 for empty rows. CPU: the plain
    version; CUDA: the kernel. Not differentiable: callers route gradients by
    the slots."""
    if data.device.type == "cpu":
        return segment_extremum_argmax_plain(data, plan, num_nodes, is_max)
    _require_cuda(data, "planned_segment_extremum_with_argmax")
    with torch.cuda.device(data.device):
        plan, vals = _row_reduce_setup(data, plan, num_nodes, "extremum")
        if data.shape[0] >= 2**31:
            raise ValueError("slot ids must fit in int32")
        args = torch.empty(vals.shape, dtype=torch.int32, device=data.device)
        if vals.numel() == 0:
            return vals, args
        partials, counters = _row_reduce_scratch(data, num_nodes)
        # The int32 slot partials beside the float32 ones, of the same capacity.
        partial_slots = _scratch(data.device, "partial_slots", partials.numel(), torch.int32)
        fn = cuda_build.kernel_function("extremum_argmax")
        err = fn(
            data.data_ptr(), _KERNEL_DTYPES[data.dtype], int(is_max), plan.row_offsets.data_ptr(),
            plan.row_slots.data_ptr(), plan.local_rows.data_ptr(), plan.tile_row_blocks.data_ptr(),
            plan.counts.data_ptr(), vals.data_ptr(), args.data_ptr(), partials.data_ptr(),
            partial_slots.data_ptr(), partials.numel(), counters.data_ptr(),
            counters.numel(), num_nodes, data.shape[0], plan.tile, plan.counts.shape[1], data.shape[1],
            ROW_CHUNK, _stream(data.device),
        )
        cuda_build.check("extremum_argmax", err)
    tracing.count("segment_extremum_argmax")
    return vals, args


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
    with torch.cuda.device(data.device):
        plan, out = _row_reduce_setup(data, plan, num_nodes, "sum")
        if out.numel() == 0:
            return out
        partials, counters = _row_reduce_scratch(data, num_nodes)
        fn = cuda_build.kernel_function("sum")
        err = fn(
            data.data_ptr(), _KERNEL_DTYPES[data.dtype], plan.row_offsets.data_ptr(),
            plan.row_slots.data_ptr(), plan.local_rows.data_ptr(), plan.tile_row_blocks.data_ptr(),
            out.data_ptr(), partials.data_ptr(), partials.numel(), counters.data_ptr(),
            counters.numel(), num_nodes, data.shape[0], plan.tile, plan.counts.shape[1],
            data.shape[1], ROW_CHUNK, _stream(data.device),
        )
        cuda_build.check("sum", err)
    tracing.count("segment_sum")
    return out


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


def extremum_indicator(data: torch.Tensor, extremum_rows: torch.Tensor) -> torch.Tensor:
    """[E, D] float32 1 where a slot's value equals its row's extremum: the
    slots among which the extremum's backward splits the cotangent."""
    return (data == extremum_rows).float()


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
        is_ext = extremum_indicator(data, rows[:, :d])
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
    """Masked segment reduce of [E_pad, ...] slot data over a batch's unified
    edge layout; trailing dims are flattened for the kernels and restored
    after. Sum/mean use the supertile plan; max/min need the receiver-sorted
    edge tiles."""
    if reduction in ("sum", "add", "mean"):
        plan = sum_plan_from_adjacency(adj)
    else:
        plan = plan_from_adjacency(adj)
    trailing = data.shape[1:]
    out = planned_segment_reduce(data.reshape(data.shape[0], -1), plan, num_nodes, reduction, mask, counts_exact)
    return out.reshape((num_nodes,) + trailing)


# The counters :func:`launch_counts` reports, all of them always: the kernel
# wrappers' launches (``ops/typed_linear.py``'s and ``ops/keyed_dropout.py``'s
# besides this module's) and the elements the fused op's keyed
# message-dropout hash covered (``ops/fused_mp.py``).
LAUNCH_COUNTERS = ("segment_extremum", "segment_extremum_argmax", "broadcast_to_edges", "segment_sum",
                   "typed_matmul", "typed_dw", "keyed_dropout", "keyed_dropout_elements")


def launch_counts() -> Dict[str, int]:
    """:data:`LAUNCH_COUNTERS` as the counter table holds them now."""
    return {name: tracing.counter(name) for name in LAUNCH_COUNTERS}


def reset_launch_counts() -> None:
    tracing.reset_counters(*LAUNCH_COUNTERS)
