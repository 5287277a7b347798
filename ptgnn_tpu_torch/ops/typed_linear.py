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
  route against ``W^T``, dW from per-type masked float32 products.
* Elsewhere (Graph2Class's 64-wide weights, float32) it is the gathered
  stack and one ``torch.bmm``, as XLA's route in the JAX package; its
  gradients are stock autograd.

The fused op's backward calls :func:`typed_tile_matmul` without autograd
and forms dW itself (``ops/fused_mp.py``).
"""
from __future__ import annotations

import torch

from ptgnn_tpu_torch.ops import cuda_build
from ptgnn_tpu_torch.ops.segment import take_rows

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
    (under its device guard); counts its launches in
    ``typed_matmul_kernel.launches``."""
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
    typed_matmul_kernel.launches += 1
    return y


typed_matmul_kernel.launches = 0


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
    against W^T; dW[t] = x^T (dy masked to type t's slots), float32."""

    @staticmethod
    def forward(ctx, x, weight_stack, tile_types, edge_tile):
        ctx.save_for_backward(x, weight_stack, tile_types)
        ctx.edge_tile = edge_tile
        return typed_matmul(x, weight_stack, tile_types, edge_tile)

    @staticmethod
    def backward(ctx, dy):
        x, weight_stack, tile_types = ctx.saved_tensors
        tile = ctx.edge_tile
        dx = typed_matmul(dy.to(x.dtype), weight_stack.transpose(1, 2), tile_types, tile)
        acc = torch.promote_types(x.dtype, torch.float32)
        tt_e = tile_types.long().repeat_interleave(tile)
        x_acc, dy_acc = x.to(acc), dy.to(x.dtype).to(acc)
        d_w = torch.stack([
            x_acc.T @ (dy_acc * (tt_e == t)[:, None]) for t in range(weight_stack.shape[0])
        ]).to(weight_stack.dtype)
        return dx, d_w, None, None


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
