"""Batched Luong-style attention with length masking: the counterpart of the
JAX package's ``sequence/luongattention.py`` (no task model uses it)."""
from __future__ import annotations

import torch

from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Linear


class LuongAttentionModule(torch.nn.Module):
    """Luong attention with the memories-to-lookup inner product ``Whd``
    (``N(0, 1)``), then a bias-free ``Wout`` and tanh."""

    def __init__(self, memories_hidden_dimension: int, lookup_hidden_dimension: int, output_size: int):
        super().__init__()
        self.memories_hidden_dimension = memories_hidden_dimension
        self.lookup_hidden_dimension = lookup_hidden_dimension
        self.Whd = torch.nn.Parameter(torch.empty(memories_hidden_dimension, lookup_hidden_dimension))
        self.Wout = Linear(memories_hidden_dimension + lookup_hidden_dimension, output_size, use_bias=False,
                           weight_init=init.kaiming_uniform())

    def reset_parameters(self, generator=None) -> None:
        init.normal()(self.Whd.data, generator)

    def get_attention_vector(self, lookup_vectors, memories, memories_length) -> torch.Tensor:
        """memories [B, L_in, H]; lengths [B]; lookups [B, L_out, D] ->
        attention [B, L_out, L_in]. A sample without memories attends to
        nothing (zeros)."""
        memories_in_d = torch.einsum("blh,hd->bld", memories, self.Whd)
        logits = torch.einsum("bld,bqd->bql", memories_in_d, lookup_vectors)
        positions = torch.arange(memories.shape[1], device=memories.device)
        mask = (positions[None, :] >= memories_length[:, None])[:, None, :]  # [B, 1, L_in]
        logits = torch.where(mask, torch.full((), -torch.inf, dtype=logits.dtype, device=logits.device), logits)
        probs = torch.softmax(logits, dim=-1)
        return torch.where(torch.isnan(probs), torch.zeros((), dtype=probs.dtype, device=probs.device), probs)

    def forward(self, *, memories, memories_length, lookup_vectors) -> torch.Tensor:
        out, _ = self.forward_with_attention_vec(
            memories=memories, memories_length=memories_length, lookup_vectors=lookup_vectors)
        return out

    def forward_with_attention_vec(self, *, memories, memories_length, lookup_vectors):
        attention = self.get_attention_vector(lookup_vectors, memories, memories_length)
        contexts = torch.einsum("blq,bqh->blh", attention, memories)
        hc = torch.cat([contexts, lookup_vectors], dim=-1)
        return torch.tanh(self.Wout(hc)), attention
