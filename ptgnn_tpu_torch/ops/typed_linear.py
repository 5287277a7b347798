"""Per-edge-type linear maps as one tile-batched matmul, with the typed
matmul kernel for Hopper.

Every tile of ``edge_tile`` consecutive edges has one type (the batcher's
layout), so ``y[e] = x[e] @ W[type(e)]`` is a matmul of each tile by its
type's weight block. The counterpart of the JAX package's
``ops/typed_linear.py``:

* Where the gathered ``[n_tiles, D, M]`` weight stack is large (wide D, few
  types: PPI's message weights, bf16 only), :func:`typed_tile_matmul` takes
  the typed matmul route: ``csrc/typed_matmul.cu`` on the card, which
  replaces the Pallas ``_pallas_typed_matmul_impl`` and reads each tile's
  weight block in place, and :func:`typed_matmul_plain` on the CPU. Its
  gradient is :class:`_TypedMatmul` (the JAX custom VJP): dx from the same
  route against ``W^T``, dW from :func:`typed_weight_gradient`.
* Elsewhere (Graph2Class's 64-wide weights, float32) it is the gathered
  stack and one ``torch.bmm``, as XLA's route in the JAX package; its
  gradients are stock autograd.

The weight gradient of a typed product, ``dW[t] = sum over the tiles of
type t of x_i^T g_i`` in float32, is one function for both of its callers
(:class:`_TypedMatmul` and the fused op's backward, ``ops/fused_mp.py``):
:func:`typed_weight_gradient`, the typed dW kernel ``csrc/typed_dw.cu`` on
the card where :func:`use_typed_dw_kernel` opens (bf16), and
:func:`typed_weight_gradient_plain`, the per-type masked float32 products,
on the CPU and where the gate stays shut.
"""
from __future__ import annotations

import functools

import torch

from ptgnn_tpu_torch.ops import cuda_build
from ptgnn_tpu_torch.ops.segment import take_rows
from ptgnn_tpu_torch.utils import tracing

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def use_typed_matmul_kernel(x: torch.Tensor, weight_stack: torch.Tensor, edge_tile: int) -> bool:
    """The JAX package's gate (``_use_pallas_typed_matmul``) without its TPU
    clauses: bf16 only, D and M multiples of 128, a weight block of at least
    128 KB and a gathered stack of at least 32 MB (smaller stacks are cheap
    to gather, and the bmm route wins there on the TPU)."""
    if x.dtype != torch.bfloat16:
        return False
    _, d, m = weight_stack.shape
    if d % 128 or m % 128:
        return False
    n_tiles = x.shape[0] // edge_tile
    itemsize = x.element_size()
    return d * m * itemsize >= 128 * 1024 and n_tiles * d * m * itemsize >= 32 * 1024 * 1024


def typed_matmul_plain(
    x: torch.Tensor, weight_stack: torch.Tensor, tile_types: torch.Tensor, edge_tile: int
) -> torch.Tensor:
    """Plain version of the typed matmul kernel: each type's tiles times that
    type's block (cast to x's dtype), accumulated in float32 (float64 for
    float64 x) and rounded once to x's dtype; tiles of a type outside
    [0, T) read zeros. No gathered ``[n_tiles, D, M]`` stack is formed."""
    e, d = x.shape
    num_types, _, m = weight_stack.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    w = weight_stack.to(x.dtype)
    xt = x.reshape(e // edge_tile, edge_tile, d)
    y = x.new_zeros((e // edge_tile, edge_tile, m))
    tt = tile_types.long()
    for t in range(num_types):
        sel = (tt == t).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        rows = xt.index_select(0, sel).reshape(-1, d).to(acc)
        y.index_copy_(0, sel, (rows @ w[t].to(acc)).to(x.dtype).reshape(-1, edge_tile, m))
    return y.reshape(e, m)


def typed_matmul_kernel(
    x: torch.Tensor, weight_stack: torch.Tensor, tile_types: torch.Tensor, edge_tile: int
) -> torch.Tensor:
    """The typed matmul kernel (``csrc/typed_matmul.cu``) on CUDA tensors:
    x [E, D] float32/bf16, weight_stack [T, D, M], tile_types [E // edge_tile]
    int32. The kernel takes each type's block transposed ([T, M, D], D
    contiguous), cast to x's dtype here: a copy of the forward's stack, and
    none for the backward's dx call, which passes W's transpose. Raises on
    what the kernel does not take; launches on x's card
    (under its device guard); counts its launches in the counter table
    (``typed_matmul``)."""
    if x.device.type != "cuda":
        raise ValueError(f"typed_matmul_kernel: no kernel for a tensor on {x.device}")
    if x.dtype not in _KERNEL_DTYPES or x.ndim != 2 or weight_stack.ndim != 3:
        raise ValueError("the typed matmul takes x [E, D] float32/bfloat16 and W [T, D, M]")
    e, d = x.shape
    num_types, d_w, m = weight_stack.shape
    vec = 16 // x.element_size()
    if d_w != d or e % edge_tile or d % vec or m % vec:
        raise ValueError(
            f"typed matmul shapes x {tuple(x.shape)}, W {tuple(weight_stack.shape)}, tile "
            f"{edge_tile}: D must match, E must be whole tiles, D and M multiples of {vec}"
        )
    if tile_types.dtype != torch.int32 or tile_types.shape != (e // edge_tile,):
        raise ValueError("tile_types must be an int32 tensor of one entry per tile")
    if weight_stack.device != x.device or tile_types.device != x.device:
        raise ValueError("x, the weights and the tile types must lie on one device")
    with torch.cuda.device(x.device):
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        w_t = weight_stack.transpose(1, 2)
        if w_t.dtype != x.dtype or not w_t.is_contiguous() or w_t.data_ptr() % 16:
            w_t = torch.empty(w_t.shape, dtype=x.dtype, device=x.device).copy_(w_t)
        tile_types = tile_types.contiguous()
        y = torch.empty((e, m), dtype=x.dtype, device=x.device)
        fn = cuda_build.kernel_function("typed_matmul")
        err = fn(
            x.data_ptr(), w_t.data_ptr(), tile_types.data_ptr(), y.data_ptr(), _KERNEL_DTYPES[x.dtype],
            e // edge_tile, edge_tile, d, m, num_types, torch.cuda.current_stream(x.device).cuda_stream,
        )
        cuda_build.check("typed_matmul", err)
    tracing.count("typed_matmul")
    return y


def typed_matmul(
    x: torch.Tensor, weight_stack: torch.Tensor, tile_types: torch.Tensor, edge_tile: int
) -> torch.Tensor:
    """The typed matmul route: the plain version for a tensor on the CPU, the
    kernel for one on a CUDA device."""
    if x.device.type == "cpu":
        return typed_matmul_plain(x, weight_stack, tile_types, edge_tile)
    return typed_matmul_kernel(x, weight_stack, tile_types, edge_tile)


class _TypedMatmul(torch.autograd.Function):
    """:func:`typed_matmul` with the JAX custom VJP: dx from the same route
    against W^T; dW[t] = x^T (dy masked to type t's slots), float32, by
    :func:`typed_weight_gradient` where its gate opens."""

    @staticmethod
    def forward(ctx, x, weight_stack, tile_types, edge_tile):
        ctx.save_for_backward(x, weight_stack, tile_types)
        ctx.edge_tile = edge_tile
        return typed_matmul(x, weight_stack, tile_types, edge_tile)

    @staticmethod
    def backward(ctx, dy):
        x, weight_stack, tile_types = ctx.saved_tensors
        tile = ctx.edge_tile
        dy = dy.to(x.dtype)
        dx = typed_matmul(dy, weight_stack.transpose(1, 2), tile_types, tile)
        dw = typed_weight_gradient if use_typed_dw_kernel(x, dy.shape[1]) else typed_weight_gradient_plain
        d_w = dw(x, dy, tile_types, tile, weight_stack.shape[0]).to(weight_stack.dtype)
        return dx, d_w, None, None


# ---------------------------------------------------------------------------
# The weight gradient of a typed product (K6)
# ---------------------------------------------------------------------------

# The most edge types the kernel counts in shared memory.
TYPED_DW_MAX_TYPES = 1024


def use_typed_dw_kernel(x: torch.Tensor, m: int) -> bool:
    """K6's gate, read from the product's compute dtype and device and its
    widths (Din = x's columns, M): bf16 on the CPU (the plain version) or a
    CUDA card, Din and M multiples of 8 (the kernel's TMA rows are whole
    16-byte vectors). Any tile: a box never crosses one. ``chip_smoke.py``
    times the kernel against the route it replaced at every shape a path
    opens it at. Float32 (and every other dtype) keeps the routes it had."""
    if x.dtype != torch.bfloat16 or x.device.type not in ("cpu", "cuda"):
        return False
    return x.shape[1] % 8 == 0 and m % 8 == 0


def typed_weight_gradient_plain(
    x: torch.Tensor, g: torch.Tensor, tile_types: torch.Tensor, edge_tile: int, num_types: int
) -> torch.Tensor:
    """Plain version of the typed dW kernel: [num_types, Din, M], the per-type
    products ``x^T (g masked to type t's slots)`` in float32 (float64 for
    float64 x) over every slot, with both operands cast up once; tiles of a
    type outside [0, num_types) add nothing."""
    acc = torch.promote_types(x.dtype, torch.float32)
    tt_e = tile_types.long().repeat_interleave(edge_tile)
    x_acc, g_acc = x.to(acc), g.to(acc)
    return torch.stack([x_acc.T @ (g_acc * (tt_e == t)[:, None]) for t in range(num_types)])


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` where TMA can read it in place (unit column stride, a row stride
    of whole 16-byte vectors, a 16-byte aligned start), else a copy."""
    if t.stride(1) != 1 or t.stride(0) % 8 or t.stride(0) < t.shape[1] or t.data_ptr() % 16:
        return t.contiguous() if not t.is_contiguous() else t.clone()
    return t


@functools.lru_cache(maxsize=None)
def typed_dw_plan(num_tiles: int, edge_tile: int, din: int, m: int, num_types: int, sms: int) -> tuple:
    """(chunk length, partial slots) of the typed dW kernel: each work unit
    sums one chunk of at most ``chunk length`` tiles of one type. The length
    is the one whose units, at most ``num_tiles // length + num_types``
    chunks times the (din, m) blocks, cost least in waves of ``sms`` units,
    a unit taking its tiles' loads and its float32 partial's write and read
    (the second pass); tried at whole waves, with and without room left for
    each type's partly filled last chunk."""
    bn = 64 if m <= 64 else 128 if m <= 128 else 256
    blocks = -(-din // 128) * -(-m // bn)
    stage_rows = 64 * -(-edge_tile // 64)
    partial_tiles = (128 * bn * 4 * 2) / (stage_rows * (128 + bn) * 2)
    best = None
    for waves in range(1, 9):
        for spare in (num_types * blocks, 0):
            room = waves * sms - spare
            if room <= 0:
                continue
            length = max(1, -(-num_tiles * blocks // room))
            units = (num_tiles // length + num_types) * blocks
            cost = -(-units // sms) * (length + partial_tiles)
            if best is None or cost < best[0]:
                best = (cost, length)
    length = best[1]
    return length, num_tiles // length + num_types


def typed_dw_kernel(
    x: torch.Tensor, g: torch.Tensor, tile_types: torch.Tensor, edge_tile: int, num_types: int
) -> torch.Tensor:
    """The typed dW kernel (``csrc/typed_dw.cu``) on CUDA tensors: x [E, Din]
    and g [E, M] bf16 (g may be a row-strided view, read in place), tile_types
    [E // edge_tile] int32. Returns [num_types, Din, M] float32. Raises on what
    the kernel does not take; launches on x's card (under its device guard);
    counts its launches in the counter table (``typed_dw``) by (tiles, tile,
    Din, M, types)."""
    if x.device.type != "cuda":
        raise ValueError(f"typed_dw_kernel: no kernel for a tensor on {x.device}")
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16 or x.ndim != 2 or g.ndim != 2:
        raise ValueError("the typed dW kernel takes x [E, Din] and g [E, M], both bfloat16")
    e, din = x.shape
    m = g.shape[1]
    if g.shape[0] != e or e % edge_tile or din % 8 or m % 8:
        raise ValueError(
            f"typed dW shapes x {tuple(x.shape)}, g {tuple(g.shape)}, tile {edge_tile}: E must match and be "
            "whole tiles, Din and M multiples of 8"
        )
    n_tiles = e // edge_tile
    if tile_types.dtype != torch.int32 or tile_types.shape != (n_tiles,):
        raise ValueError("tile_types must be an int32 tensor of one entry per tile")
    if g.device != x.device or tile_types.device != x.device:
        raise ValueError("x, g and the tile types must lie on one device")
    if not 1 <= num_types <= TYPED_DW_MAX_TYPES or n_tiles >= 2**30:
        raise ValueError(f"the typed dW kernel takes 1 to {TYPED_DW_MAX_TYPES} types and fewer than 2**30 tiles")
    with torch.cuda.device(x.device):
        if n_tiles == 0:
            return torch.zeros((num_types, din, m), dtype=torch.float32, device=x.device)
        x, g = _aligned_rows(x), _aligned_rows(g)
        tile_types = tile_types.contiguous()
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        chunk_len, max_chunks = typed_dw_plan(n_tiles, edge_tile, din, m, num_types, sms)
        partial = torch.empty(max_chunks * din * m, dtype=torch.float32, device=x.device)
        chunk_base = torch.empty(num_types + 1, dtype=torch.int32, device=x.device)
        out = torch.empty((num_types, din, m), dtype=torch.float32, device=x.device)
        fn = cuda_build.kernel_function("typed_dw")
        err = fn(
            x.data_ptr(), x.stride(0), g.data_ptr(), g.stride(0), tile_types.data_ptr(), partial.data_ptr(),
            chunk_base.data_ptr(), out.data_ptr(), n_tiles, edge_tile, din, m, num_types, chunk_len, max_chunks,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        cuda_build.check("typed_dw", err)
    tracing.count("typed_dw", (n_tiles, edge_tile, din, m, num_types))
    return out


def typed_weight_gradient(
    x: torch.Tensor, g: torch.Tensor, tile_types: torch.Tensor, edge_tile: int, num_types: int
) -> torch.Tensor:
    """dW of a typed product: ``[num_types, Din, M]``, row block t the sum
    over the slots of type t's tiles of ``x^T g``, float32 sums of the
    operands' products. The plain version for a tensor on the CPU, the
    kernel for one on a CUDA device. Callers take it where
    :func:`use_typed_dw_kernel` opens."""
    if x.device.type == "cpu":
        return typed_weight_gradient_plain(x, g, tile_types, edge_tile, num_types)
    return typed_dw_kernel(x, g, tile_types, edge_tile, num_types)


def typed_tile_matmul(
    x: torch.Tensor, weight_stack: torch.Tensor, tile_types: torch.Tensor, edge_tile: int
) -> torch.Tensor:
    """x: [E, D]; weight_stack: [T, D, M]; tile_types: [E // edge_tile].
    Returns [E, M] in x's dtype, row e = x[e] @ weight_stack[type(e)]: the
    typed matmul route where :func:`use_typed_matmul_kernel` opens, else the
    gathered stack and ``torch.bmm``."""
    e, d = x.shape
    if e % edge_tile:
        raise ValueError(f"{e} edge slots are not a multiple of the tile {edge_tile}")
    if use_typed_matmul_kernel(x, weight_stack, edge_tile):
        return _TypedMatmul.apply(x, weight_stack, tile_types, edge_tile)
    m = weight_stack.shape[-1]
    xt = x.reshape(e // edge_tile, edge_tile, d)
    wt = take_rows(weight_stack.reshape(weight_stack.shape[0], -1), tile_types)
    wt = wt.reshape(-1, d, m).to(x.dtype)  # [nt, D, M]
    return torch.bmm(xt, wt).reshape(e, m)


def typed_tile_bias_add(
    y: torch.Tensor, bias_stack: torch.Tensor, tile_types: torch.Tensor, edge_tile: int
) -> torch.Tensor:
    """y: [E, M] plus each row's type's bias: bias_stack [T, M] taken by
    tile_types [E // edge_tile], in y's dtype."""
    e, m = y.shape
    if e % edge_tile:
        raise ValueError(f"{e} edge slots are not a multiple of the tile {edge_tile}")
    bt = take_rows(bias_stack, tile_types).to(y.dtype)  # [nt, M]
    return (y.reshape(e // edge_tile, edge_tile, m) + bt[:, None, :]).reshape(e, m)
