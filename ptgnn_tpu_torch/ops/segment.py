"""Segment (scatter) reductions over a padded element array, in stock
PyTorch ops with autograd: the counterpart of the JAX package's
``ops/segment.py``, which leaves this work to XLA.

Semantics (torch-scatter's, as the JAX package has them):

* every reduction returns 0 for a segment that receives no element, except
  ``segment_logsumexp``, which returns -inf there;
* ``segment_mean`` divides by max(count, 1);
* bf16/f16 inputs are accumulated in float32 and cast back;
* an optional boolean ``mask`` marks the valid elements, and out-of-range
  segment ids (padding points at id ``num_segments``) are dropped.

The extrema split their gradient evenly among tied elements (JAX's
``segment_max``): ``scatter_reduce`` with ``include_self=False`` into a
neutral-filled output does that.

:func:`segment_sum` (and the sums, means, counts and softmax denominators
built on it) gives the same bits on every run: on the CPU it is
``index_add``; on a CUDA tensor it sorts the ids stably and runs the
row-indexed segment sum kernel over them (``ops/segment_kernels.py``), in
place of ``index_add_``'s float atomics. :func:`take_rows` (and
:func:`masked_take`) gathers rows with a backward that is such a sum, where
``index_select``'s backward would be ``index_add_``.
"""
from __future__ import annotations

from typing import Optional

import torch

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class _TakeRows(torch.autograd.Function):
    """``values.index_select(0, idx)`` whose backward adds each row's
    cotangents with :func:`segment_sum`, in one fixed order."""

    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = values.shape[0]
        return values.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return segment_sum(g, idx, ctx.num_rows), None


def take_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values.index_select(0, idx)`` for ids in range. On the card, where
    the gradient flows, its backward is :func:`segment_sum` (the same bits
    on every run) in place of ``index_add_``, which adds in atomic order
    where an id repeats; on the CPU it is ``index_select`` itself."""
    if (values.device.type == "cuda" and values.requires_grad and torch.is_grad_enabled()
            and values.dtype in (torch.float32, torch.bfloat16)):
        return _TakeRows.apply(values, idx.long())
    return values.index_select(0, idx.long())


def masked_take(values: torch.Tensor, idx: torch.Tensor, fill: float) -> torch.Tensor:
    """``values[idx]`` along dim 0, ``fill`` where ``idx`` is out of range:
    JAX's ``take(..., mode="fill", fill_value=fill)``. ``index_select`` would
    raise on such an id on the CPU and assert on the card."""
    valid = (idx >= 0) & (idx < values.shape[0])
    got = take_rows(values, torch.where(valid, idx, torch.zeros_like(idx)))
    valid = valid.reshape(valid.shape + (1,) * (got.ndim - 1))
    return torch.where(valid, got, torch.full((), fill, dtype=values.dtype, device=values.device))


def _expand_mask(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Broadcast an [E] mask against [E, ...] data."""
    return mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))


def _promote(data: torch.Tensor):
    if data.dtype in _LOW_PRECISION:
        return data.float(), data.dtype
    return data, None


def _in_range(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (segment_ids >= 0) & (segment_ids < num_segments)


class _SortedSegmentSum(torch.autograd.Function):
    """[E, D] float32/bf16 data -> [num_segments, D] float32 sums on the
    card: K1 over the row index of a one-tile plan whose rows are the ids
    (a stable sort of them), so the sums add in one fixed order. Backward:
    the cotangent's row of each element (0 at out-of-range ids)."""

    @staticmethod
    def forward(ctx, data, rows, num_segments):
        from ptgnn_tpu_torch.ops.segment_kernels import AggregationPlan, planned_segment_sum

        ctx.save_for_backward(rows)
        ctx.data_dtype = data.dtype
        # The row index from the sort alone (the dropped elements' sentinel
        # num_segments sorts last), with nothing that waits for the card.
        sorted_rows, order = torch.sort(rows, stable=True)
        starts = torch.arange(num_segments + 1, dtype=rows.dtype, device=rows.device)
        plan = AggregationPlan(
            local_rows=rows,
            tile_row_blocks=torch.zeros(1, dtype=torch.int32, device=data.device),
            counts=torch.zeros((1, num_segments), dtype=torch.int32, device=data.device),
            row_offsets=torch.searchsorted(sorted_rows, starts).int(),
            row_slots=torch.where(sorted_rows < num_segments, order, -1).int(),
        )
        return planned_segment_sum(data, plan, num_segments)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        return masked_take(g, rows, 0.0).to(ctx.data_dtype), None, None


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[num_segments, ...] sums; masked elements and out-of-range ids add
    nothing (they go to a spare row that is cut off). The same bits on
    every run, on the card too (see the module docstring)."""
    data, orig = _promote(data)
    if mask is not None:
        data = torch.where(_expand_mask(mask, data), data, torch.zeros((), dtype=data.dtype, device=data.device))
    rows = torch.where(_in_range(segment_ids, num_segments), segment_ids, num_segments)
    if data.device.type == "cuda":
        if data.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"segment_sum on the card takes float32 or bfloat16 data, not {data.dtype}")
        if data.shape[0] == 0 or num_segments == 0 or data[0].numel() == 0:
            out = data.new_zeros((num_segments,) + data.shape[1:])
        else:
            flat = data.reshape(data.shape[0], -1).contiguous()
            out = _SortedSegmentSum.apply(flat, rows.int().contiguous(), num_segments)
            out = out.to(data.dtype).reshape((num_segments,) + data.shape[1:])
    else:
        out = data.new_zeros((num_segments + 1,) + data.shape[1:]).index_add(0, rows.long(), data)[:num_segments]
    return out.to(orig) if orig is not None else out


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape, dtype=torch.float32, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask).to(dtype)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    data, orig = _promote(data)
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask, dtype=data.dtype).clamp_min(1)
    out = total / count.reshape(count.shape + (1,) * (total.ndim - count.ndim))
    return out.to(orig) if orig is not None else out


def _segment_extremum(data, segment_ids, num_segments, mask, is_max: bool, empty_fill):
    work = data.float() if data.dtype in _LOW_PRECISION else data
    if work.is_floating_point():
        neutral = -torch.inf if is_max else torch.inf
    else:
        info = torch.iinfo(work.dtype)
        neutral = info.min if is_max else info.max
    # As in the JAX package: out-of-range ids go to segment 0 with the
    # neutral value (it never wins against a real element, and a segment
    # that only padding reaches gets ``empty_fill``).
    in_range = _in_range(segment_ids, num_segments)
    valid = in_range if mask is None else mask & in_range
    rows = torch.where(in_range, segment_ids, 0).long()
    fill = torch.full((), neutral, dtype=work.dtype, device=work.device)
    work = torch.where(_expand_mask(valid, work), work, fill)
    index = rows.reshape(rows.shape + (1,) * (work.ndim - 1)).expand(work.shape)
    # include_self=False over a neutral-filled output: the gradient splits
    # evenly among the tied elements alone.
    out = torch.full((num_segments,) + work.shape[1:], neutral, dtype=work.dtype, device=work.device)
    out = out.scatter_reduce(0, index, work, "amax" if is_max else "amin", include_self=False)
    if empty_fill is not None:
        count = segment_count(rows, num_segments, valid)
        nonempty = count.reshape(count.shape + (1,) * (out.ndim - 1)) > 0
        out = torch.where(nonempty, out, torch.full((), empty_fill, dtype=out.dtype, device=out.device))
    return out.to(data.dtype)


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    empty_fill: Optional[float] = 0.0,
) -> torch.Tensor:
    """Per-segment max; an empty segment gets ``empty_fill`` (torch-scatter:
    0), or -inf (the dtype's least integer) with ``empty_fill=None``."""
    return _segment_extremum(data, segment_ids, num_segments, mask, True, empty_fill)


def segment_min(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    empty_fill: Optional[float] = 0.0,
) -> torch.Tensor:
    return _segment_extremum(data, segment_ids, num_segments, mask, False, empty_fill)


def segment_reduce(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    reduction: str,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """torch_scatter.scatter(reduce=...)."""
    if reduction in ("sum", "add"):
        return segment_sum(data, segment_ids, num_segments, mask)
    if reduction == "mean":
        return segment_mean(data, segment_ids, num_segments, mask)
    if reduction == "max":
        return segment_max(data, segment_ids, num_segments, mask)
    if reduction == "min":
        return segment_min(data, segment_ids, num_segments, mask)
    raise ValueError(f"Unknown reduction '{reduction}'")


def segment_logsumexp(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment logsumexp with a finite shift (torch-scatter's, eps=0): an
    empty segment, or one of -inf entries only, gives -inf, and its gradient
    is 0, not NaN."""
    data, orig = _promote(data)
    shift = _segment_extremum(data, segment_ids, num_segments, mask, True, 0.0)
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros((), dtype=data.dtype, device=data.device)).detach()
    # jnp indexing clamps: an out-of-range element reads the last shift (it
    # is dropped from the sum all the same).
    shifted = data - shift.index_select(0, segment_ids.clamp(0, num_segments - 1).long())
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    expd = torch.where(torch.isnan(shifted), zero, torch.exp(shifted))  # (-inf) - (-inf)
    if mask is not None:
        expd = torch.where(_expand_mask(mask, expd), expd, zero)
    denom = segment_sum(expd, segment_ids, num_segments)
    # log(0)'s backward is inf * 0: the inner where keeps it out.
    nonempty = denom > 0
    log_denom = torch.where(
        nonempty,
        torch.log(torch.where(nonempty, denom, torch.ones((), dtype=denom.dtype, device=denom.device))),
        torch.full((), -torch.inf, dtype=denom.dtype, device=denom.device),
    )
    out = log_denom + shift
    return out.to(orig) if orig is not None else out


def segment_log_softmax(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment log-softmax (torch-scatter's, eps=0); masked entries give
    -inf."""
    data, orig = _promote(data)
    lse = segment_logsumexp(data, segment_ids, num_segments, mask)
    # A -inf lse (an empty or all-padding segment) would leak NaN into the
    # backward: a finite stand-in, and 0 for out-of-range ids.
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros((), dtype=lse.dtype, device=lse.device))
    out = data - masked_take(lse_safe, segment_ids, 0.0)
    if mask is not None:
        out = torch.where(_expand_mask(mask, out), out,
                          torch.full((), -torch.inf, dtype=out.dtype, device=out.device))
    return out.to(orig) if orig is not None else out


def segment_softmax(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    out = torch.exp(segment_log_softmax(data, segment_ids, num_segments, mask))
    if mask is not None:
        out = torch.where(_expand_mask(mask, out), out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def segment_argmax(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[num_segments] int32 index into 1-D ``data`` of each segment's max;
    a tie goes to the first occurrence, an empty segment gives
    ``len(data)``."""
    if data.ndim != 1:
        raise ValueError("segment_argmax takes 1-D data")
    n = data.shape[0]
    maxes = segment_max(data, segment_ids, num_segments, mask, empty_fill=None)
    is_max = data == maxes.index_select(0, segment_ids.clamp(0, num_segments - 1).long())
    if mask is not None:
        is_max = is_max & mask
    positions = torch.arange(n, dtype=torch.int32, device=data.device)
    idxs = torch.where(is_max, positions, torch.full((), n, dtype=torch.int32, device=data.device))
    return segment_min(idxs, segment_ids, num_segments, mask=None, empty_fill=n)
