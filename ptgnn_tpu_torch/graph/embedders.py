"""Node embedders: string labels split into subtokens.

Minibatches are statically padded: every finalize takes ``pad_to`` (the node
budget) and the subtoken width is the static ``max_num_subtokens``.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Embedding, Linear, dropout
from ptgnn_tpu_torch.utils.text import Vocabulary, split_identifier_into_parts


class SubtokenUnitEmbedder(torch.nn.Module):
    """Subtoken embedding with masked mean/sum pooling, then a bias-free
    dense layer."""

    def __init__(
        self,
        vocabulary_size: int,
        embedding_size: int,
        dropout_rate: float,
        subtoken_combination_kind: str,
    ):
        super().__init__()
        if subtoken_combination_kind not in {"mean", "sum"}:
            raise NotImplementedError(f"subtoken combination {subtoken_combination_kind!r}")
        self.combination = subtoken_combination_kind
        self.embeddings = Embedding(vocabulary_size, embedding_size, weight_init=init.uniform())
        self.out_layer = Linear(
            embedding_size, embedding_size, use_bias=False, weight_init=init.xavier_uniform()
        )
        self.dropout_rate = dropout_rate

    def forward(self, token_idxs, lengths, *, train: bool = False, generator=None):
        """token_idxs: [B, max_subtok]; lengths: [B] -> [B, D]."""
        embedded = self.embeddings(token_idxs)  # [B, S, D]
        positions = torch.arange(embedded.shape[1], device=embedded.device)
        maskf = (positions[None, :] < lengths[:, None])[..., None].to(embedded.dtype)
        out = (embedded * maskf).sum(dim=-2)
        if self.combination == "mean":
            out = out / (lengths[:, None].to(embedded.dtype) + 1e-10)
        return dropout(self.out_layer(out), self.dropout_rate, train, generator)


class StrElementRepresentationModel(AbstractNeuralModel):
    """String node-label embedder; the port has the subtoken splitting."""

    def __init__(
        self,
        *,
        token_splitting: str,
        embedding_size: int = 128,
        dropout_rate: float = 0.2,
        vocabulary_size: int = 10000,
        min_freq_threshold: int = 5,
        max_num_subtokens: Optional[int] = 5,
        subtoken_combination: str = "sum",
    ):
        super().__init__()
        if token_splitting != "subtoken":
            raise NotImplementedError(f"token splitting {token_splitting!r} is not ported yet")
        self.embedding_size = embedding_size
        self.dropout_rate = dropout_rate
        self.max_num_subtokens = max_num_subtokens if max_num_subtokens is not None else 5
        self.subtoken_combination = subtoken_combination
        self.max_vocabulary_size = vocabulary_size
        self.min_freq_threshold = min_freq_threshold

    def initialize_metadata(self) -> None:
        self.__tok_counter: Counter = Counter()

    def update_metadata_from(self, datapoint: str) -> None:
        self.__tok_counter.update(split_identifier_into_parts(datapoint))

    def finalize_metadata(self) -> None:
        self.__vocabulary = Vocabulary.create_vocabulary(
            self.__tok_counter,
            max_size=self.max_vocabulary_size,
            count_threshold=self.min_freq_threshold,
        )
        del self.__tok_counter

    @property
    def vocabulary(self) -> Vocabulary:
        return self.__vocabulary

    def build_neural_module(self) -> SubtokenUnitEmbedder:
        return SubtokenUnitEmbedder(
            len(self.vocabulary), self.embedding_size, self.dropout_rate,
            self.subtoken_combination,
        )

    def tensorize(self, datapoint: str) -> List[int]:
        subtoks = split_identifier_into_parts(datapoint)
        if len(subtoks) == 0:
            subtoks = [Vocabulary.get_unk()]
        return self.vocabulary.get_id_or_unk_multiple(subtoks)

    def initialize_minibatch(self) -> Dict[str, Any]:
        return {"token_idxs": []}

    def extend_minibatch_with(self, tensorized_datapoint, partial_minibatch) -> bool:
        partial_minibatch["token_idxs"].append(tensorized_datapoint)
        return True

    def finalize_minibatch(self, accumulated_minibatch_data, pad_to: Optional[int] = None):
        items: List = accumulated_minibatch_data["token_idxs"]
        total = pad_to if pad_to is not None else len(items)
        width = self.max_num_subtokens
        subtoken_idxs = np.zeros((total, width), np.int32)
        lengths = np.zeros(total, np.int32)
        for i, subtokens in enumerate(items):
            idxs = subtokens[:width]
            subtoken_idxs[i, : len(idxs)] = idxs
            lengths[i] = len(idxs)
        return {"token_idxs": subtoken_idxs, "lengths": lengths}
