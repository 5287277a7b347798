"""Per-edge-type linear maps as one tile-batched matmul.

Every tile of ``edge_tile`` consecutive edges has one type (the batcher's
layout), so ``y[e] = x[e] @ W[type(e)]`` is a batched matmul of
``[n_tiles, tile, D]`` by the gathered ``[n_tiles, D, M]`` weights. The JAX
package leaves this to XLA at the Graph2Class shapes; here it is a plain
``torch.bmm``. The hand grouped GEMM that ports the Pallas typed matmul comes
with the slice whose path routes it.
"""
from __future__ import annotations

import torch


def typed_tile_matmul(
    x: torch.Tensor, weight_stack: torch.Tensor, tile_types: torch.Tensor, edge_tile: int
) -> torch.Tensor:
    """x: [E, D]; weight_stack: [T, D, M]; tile_types: [E // edge_tile].
    Returns [E, M] in x's dtype, row e = x[e] @ weight_stack[type(e)]."""
    e, d = x.shape
    if e % edge_tile:
        raise ValueError(f"{e} edge slots are not a multiple of the tile {edge_tile}")
    m = weight_stack.shape[-1]
    xt = x.reshape(e // edge_tile, edge_tile, d)
    wt = weight_stack.index_select(0, tile_types.long()).to(x.dtype)  # [nt, D, M]
    return torch.bmm(xt, wt).reshape(e, m)
