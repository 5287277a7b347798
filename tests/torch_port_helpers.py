"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made from numpy seeds and handed to both packages. Where the JAX
side reaches a Pallas kernel it runs in interpret mode, the way the JAX
package's own kernel tests run it on the CPU.
"""
from __future__ import annotations

import ml_dtypes
import numpy as np
import torch


def force_jax_fused_interpret(monkeypatch) -> None:
    """Route the JAX package through its fused Pallas path, interpreted."""
    import jax
    import jax.experimental.pallas as pl

    from ptgnn_tpu.ops.pallas import segment_kernels as jsk

    monkeypatch.setenv("PTGNN_TPU_FORCE_PALLAS_AGG", "1")
    # Small test tiles still reach the broadcast kernel.
    monkeypatch.setenv("PTGNN_TPU_BCAST_MIN_TILE", "1")
    if jax.default_backend() != "tpu":
        real_call = pl.pallas_call

        def patched(*args, **kwargs):
            kwargs["interpret"] = True
            kwargs.pop("cost_estimate", None)
            return real_call(*args, **kwargs)

        monkeypatch.setattr(jsk.pl, "pallas_call", patched)


def to_dtype_pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (f32 or bf16,
    identical bits)."""
    import jax.numpy as jnp

    if dtype == "float32":
        x = x.astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x.copy())
    x16 = x.astype(ml_dtypes.bfloat16)
    return jnp.asarray(x16), torch.from_numpy(x16.view(np.int16).copy()).view(torch.bfloat16)


def bits(x) -> np.ndarray:
    """The raw bits of a float32/bfloat16 JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.cpu().view(torch.int16).numpy().view(np.uint16)
        return x.cpu().numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x.view(np.uint32)
