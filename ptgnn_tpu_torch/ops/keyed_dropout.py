"""Keyed message dropout, with a hand-written CUDA kernel for Hopper.

The fused op (``ops/fused_mp.py``) drops message inputs by a mask keyed on
each slot's DIRECTED typed edge (u -> v, t), so that the transpose
orientation of its backward, where a slot carries its pair edge,
regenerates the mask the pair used. An edge's key is a uint32 hash of its
endpoint ids and type; element (e, c) of an [E, C] block is kept where
``hash(((key(e) ^ seed) + c * 0x9E3779B9) mod 2**32) >= int(rate *
0xFFFFFFFF)`` and then divided by the keep probability. The mask equals
the JAX package's bit for bit.

The ids come in as :class:`EdgeIds`: the slot's own (sender, receiver,
type) in the forward orientation, (receiver, sender) with the transposed
type of each tile in the transpose one.

* :func:`keyed_dropout_plain` hashes in int64 PyTorch ops (uint32 values
  held in int64 and masked to 32 bits): the route off the card.
* :func:`keyed_dropout_kernel` launches ``csrc/keyed_dropout.cu``, which
  keys, hashes, tests and selects in one uint32 pass over the block; its
  output equals the plain version's bit for bit. It takes float32 or bf16
  with contiguous rows and int32 ids, and raises on anything else. It
  counts its launches in ``keyed_dropout_kernel.launches`` and by (E, C,
  column offset, tile, dtype) in ``keyed_dropout_kernel.launches_by_shape``.
* :func:`keyed_dropout` takes the kernel for a CUDA tensor, the plain
  version for any other.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ptgnn_tpu_torch.ops import cuda_build

_U32 = 0xFFFFFFFF
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """xorshift-multiply avalanche hash of uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _directed_edge_key(src: torch.Tensor, dst: torch.Tensor, edge_type: torch.Tensor) -> torch.Tensor:
    """[E] uint32 key (in int64) of a DIRECTED typed edge (u -> v, t). A slot
    acting as its pair's transpose carrier computes the pair's key from its
    own endpoints: (receiver, sender, tau(type))."""
    u, v, t = (a.long() & _U32 for a in (src, dst, edge_type))
    return _hash_u32(
        _hash_u32(_mul_u32(u, 2654435761))
        ^ _hash_u32(_mul_u32(v, 2246822519))
        ^ _hash_u32(_mul_u32(t, 3266489917))
    )


def _keyed_dropout_mask(
    seed: torch.Tensor, edge_key: torch.Tensor, num_cols: int, rate: float, col_offset: int = 0
) -> torch.Tensor:
    """[E, num_cols] keep mask from the directed edge key; ``col_offset``
    regenerates a column slice of the forward's mask."""
    col = col_offset + torch.arange(num_cols, dtype=torch.int64, device=edge_key.device)
    h = _hash_u32(((edge_key[:, None] ^ seed) + _mul_u32(col, 0x9E3779B9)[None, :]) & _U32)
    return h >= int(rate * 0xFFFFFFFF)


class EdgeIds(NamedTuple):
    """The ids of each slot's directed typed edge: [E] int32 endpoints and
    one type a ``tile`` consecutive slots ([E] with tile 1, a type a slot;
    [E // tile] with the edge tile, a type a tile)."""

    src: torch.Tensor
    dst: torch.Tensor
    types: torch.Tensor
    tile: int = 1

    def key(self) -> torch.Tensor:
        """The [E] edge keys, hashed by the plain version."""
        types = self.types if self.tile == 1 else self.types.repeat_interleave(self.tile)
        return _directed_edge_key(self.src, self.dst, types)


def keyed_dropout_plain(
    x: torch.Tensor, seed: torch.Tensor, ids: EdgeIds, keep: float, col_offset: int = 0
) -> torch.Tensor:
    """Plain version of the keyed dropout kernel: x [E, C] masked by the
    keyed mask of columns ``col_offset`` on and scaled by 1 / keep."""
    mask = _keyed_dropout_mask(seed, ids.key(), x.shape[1], 1.0 - keep, col_offset)
    # The rate as a device scalar made by a fill: dividing by a Python float
    # multiplies by its reciprocal, and a tensor copied from the host waits
    # for the copy.
    return torch.where(mask, x / torch.full((), keep, dtype=x.dtype, device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def keyed_dropout_kernel(
    x: torch.Tensor, seed: torch.Tensor, ids: EdgeIds, keep: float, col_offset: int = 0
) -> torch.Tensor:
    """The keyed dropout kernel (``csrc/keyed_dropout.cu``) on CUDA tensors:
    x [E, C] float32/bf16 with contiguous rows (any row stride), ids int32
    on x's device, seed an integer tensor of one element (its low 32 bits;
    read by the kernel from device memory, so a captured launch follows a
    seed rewritten between replays). Returns a contiguous [E, C] tensor of
    x's dtype, bitwise :func:`keyed_dropout_plain`'s. Raises on what the
    kernel does not take; launches on x's card (under its device guard);
    counts its launches in ``keyed_dropout_kernel.launches`` and by (E, C,
    column offset, tile, dtype name) in
    ``keyed_dropout_kernel.launches_by_shape``."""
    if x.dtype not in _KERNEL_DTYPES or x.ndim != 2 or (x.shape[1] > 1 and x.stride(1) != 1):
        raise ValueError(f"keyed_dropout_kernel: no kernel for x {x.dtype} of shape {tuple(x.shape)} and strides "
                         f"{x.stride()}: it takes x [E, C] float32/bfloat16 with contiguous rows")
    if any(t.dtype != torch.int32 for t in ids[:3]):
        raise ValueError(f"keyed_dropout_kernel: the edge ids are {[t.dtype for t in ids[:3]]}; it takes int32")
    if x.device.type != "cuda":
        raise ValueError(f"keyed_dropout_kernel: no kernel for a tensor on {x.device}")
    e, c = x.shape
    tile = ids.tile
    if ids.src.shape != (e,) or ids.dst.shape != (e,) or tile < 1 or e % tile or ids.types.shape != (e // tile,):
        raise ValueError(f"keyed dropout ids for {e} rows: [E] endpoints and a type a {tile} rows")
    if any(t.device != x.device for t in ids[:3]):
        raise ValueError("x and the edge ids must lie on one device")
    if seed.numel() != 1 or seed.dtype.is_floating_point or seed.dtype.is_complex:
        raise ValueError("the keyed dropout seed is an integer tensor of one element")
    if e >= 2**31 or not 0 <= col_offset < 2**31 - c:
        raise ValueError("the keyed dropout kernel counts rows and columns in 32 bits")
    with torch.cuda.device(x.device):
        seed = seed.to(device=x.device, dtype=torch.int64)  # the step's own seed as it is
        # The keep probability rounded to x's dtype as the plain version's
        # fill rounds it, by a fill on the host: no device work.
        divisor = float(torch.full((), keep, dtype=x.dtype))
        src, dst, types = (t.contiguous() for t in ids[:3])
        out = torch.empty((e, c), dtype=x.dtype, device=x.device)
        fn = cuda_build.kernel_function("keyed_dropout")
        err = fn(
            x.data_ptr(), x.stride(0) if e > 1 else c, out.data_ptr(), src.data_ptr(), dst.data_ptr(),
            types.data_ptr(), tile, seed.data_ptr(), e, c, col_offset, int((1.0 - keep) * 0xFFFFFFFF),
            ctypes.c_float(divisor), _KERNEL_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        cuda_build.check("keyed_dropout", err)
    keyed_dropout_kernel.launches += 1
    key = (e, c, col_offset, tile, str(x.dtype).removeprefix("torch."))
    keyed_dropout_kernel.launches_by_shape[key] = keyed_dropout_kernel.launches_by_shape.get(key, 0) + 1
    return out


keyed_dropout_kernel.launches = 0
# The launches by (E, C, column offset, tile, dtype name): the shapes the path runs the kernel at.
keyed_dropout_kernel.launches_by_shape = {}


def keyed_dropout(
    x: torch.Tensor, seed: torch.Tensor, ids: EdgeIds, keep: float, col_offset: int = 0
) -> torch.Tensor:
    """x [E, C] with the keyed message dropout of ``seed`` applied to its
    columns ``col_offset`` on: the kernel on the card (which raises on what
    it does not take), the plain version elsewhere. Both give the same
    bits."""
    if x.device.type == "cuda":
        return keyed_dropout_kernel(x, seed, ids, keep, col_offset)
    return keyed_dropout_plain(x, seed, ids, keep, col_offset)
