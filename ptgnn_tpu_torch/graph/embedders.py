"""Node embedders: float feature vectors (PPI, edge features) and string
labels, whole (Graph2Seq's token vocabulary) or split into subtokens
(Graph2Class), byte-pair-encoded pieces or chars (VarMisuse's char CNN).

Minibatches are statically padded: every finalize takes ``pad_to`` (the node
budget), and the subtoken and char widths are the static
``max_num_subtokens`` and ``max_num_chars``.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Conv1d, Embedding, Linear, dropout
from ptgnn_tpu_torch.utils.text import BpeVocabulary, CharTensorizer, Vocabulary, split_identifier_into_parts

_ACTIVATIONS = {"tanh": torch.tanh}  # the activations a ported factory uses


class LinearFeatureEmbedder(torch.nn.Module):
    """A bias-free xavier-uniform linear map of each node's features, then an
    optional activation (``"tanh"``)."""

    def __init__(self, input_element_size: int, output_embedding_size: int,
                 activation: Optional[str] = None):
        super().__init__()
        if activation is not None and activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.linear = Linear(
            input_element_size, output_embedding_size, use_bias=False, weight_init=init.xavier_uniform()
        )
        self.activation = activation

    def forward(self, features: torch.Tensor, *, train: bool = False, generator=None) -> torch.Tensor:
        """features: [N, F] -> [N, D]."""
        out = self.linear(features)
        return out if self.activation is None else _ACTIVATIONS[self.activation](out)


class FeatureRepresentationModel(AbstractNeuralModel):
    """Node embedder for fixed-size float feature vectors."""

    def __init__(self, *, embedding_size: int = 64, activation: Optional[str] = None):
        super().__init__()
        self.embedding_size = embedding_size
        self.__activation = activation

    def representation_size(self) -> int:
        return self.embedding_size

    def initialize_metadata(self) -> None:
        self.__num_input_features: Optional[int] = None

    def update_metadata_from(self, datapoint: np.ndarray) -> None:
        if self.__num_input_features is None:
            self.__num_input_features = datapoint.shape[0]
        elif self.__num_input_features != datapoint.shape[0]:
            raise ValueError("All samples should have the same number of features.")

    def build_neural_module(self) -> LinearFeatureEmbedder:
        if self.__num_input_features is None:
            raise RuntimeError("metadata not computed")
        return LinearFeatureEmbedder(self.__num_input_features, self.embedding_size, self.__activation)

    def tensorize(self, datapoint: np.ndarray) -> np.ndarray:
        return datapoint

    def initialize_minibatch(self) -> Dict[str, Any]:
        return {"features": []}

    def extend_minibatch_with(self, tensorized_datapoint, partial_minibatch) -> bool:
        partial_minibatch["features"].append(tensorized_datapoint)
        return True

    def finalize_minibatch(self, accumulated_minibatch_data, pad_to: Optional[int] = None):
        """{"features": [pad_to or N, F] float32}, zero rows past the nodes."""
        items = accumulated_minibatch_data["features"]
        width = self.__num_input_features
        total = pad_to if pad_to is not None else len(items)
        feats = np.zeros((total, width), np.float32)
        if items:
            feats[: len(items)] = np.asarray(items, dtype=np.float32)
        return {"features": feats}


class TokenUnitEmbedder(torch.nn.Module):
    """One xavier-uniform embedding row per token id, then dropout."""

    def __init__(self, vocabulary_size: int, embedding_size: int, dropout_rate: float):
        super().__init__()
        self.embeddings = Embedding(vocabulary_size, embedding_size, weight_init=init.xavier_uniform())
        self.dropout_rate = dropout_rate

    def forward(self, token_idxs: torch.Tensor, *, train: bool = False, generator=None) -> torch.Tensor:
        """token_idxs: [B] -> [B, D]."""
        return dropout(self.embeddings(token_idxs), self.dropout_rate, train, generator)


class SubtokenUnitEmbedder(torch.nn.Module):
    """Subtoken embedding with masked mean, sum or max pooling over each
    row's ``lengths`` subtokens, then (``use_dense_output``) a bias-free
    dense layer, then dropout. A max row of length 0 (a padding node) is 0.
    The max splits its gradient evenly among tied subtokens (``amax``, as
    JAX's ``max``), so a repeated subtoken gets half of it each."""

    def __init__(
        self,
        vocabulary_size: int,
        embedding_size: int,
        dropout_rate: float,
        subtoken_combination_kind: str,
        use_dense_output: bool = True,
    ):
        super().__init__()
        if subtoken_combination_kind not in {"mean", "max", "sum"}:
            raise ValueError(f"unknown subtoken combination {subtoken_combination_kind!r}")
        self.combination = subtoken_combination_kind
        self.embeddings = Embedding(vocabulary_size, embedding_size, weight_init=init.uniform())
        self.out_layer = (
            Linear(embedding_size, embedding_size, use_bias=False, weight_init=init.xavier_uniform())
            if use_dense_output else None
        )
        self.dropout_rate = dropout_rate

    def forward(self, token_idxs, lengths, *, train: bool = False, generator=None):
        """token_idxs: [B, max_subtok]; lengths: [B] -> [B, D]."""
        embedded = self.embeddings(token_idxs)  # [B, S, D]
        positions = torch.arange(embedded.shape[1], device=embedded.device)
        mask = (positions[None, :] < lengths[:, None])[..., None]  # [B, S, 1]
        if self.combination == "max":
            filled = embedded.masked_fill(~mask, float("-inf"))
            out = torch.where(lengths[:, None] > 0, filled.amax(dim=-2), torch.zeros((), dtype=embedded.dtype,
                                                                                     device=embedded.device))
        else:
            out = (embedded * mask.to(embedded.dtype)).sum(dim=-2)
            if self.combination == "mean":
                out = out / (lengths[:, None].to(embedded.dtype) + 1e-10)
        if self.out_layer is not None:
            out = self.out_layer(out)
        return dropout(out, self.dropout_rate, train, generator)


class CnnConfig(NamedTuple):
    l1_filters: int
    l1_window_size: int
    l2_filters: int
    l2_window_size: int
    lout_window_size: int


class CharUnitEmbedder(torch.nn.Module):
    """A 3-layer char CNN over one-hot chars (relu between the layers, the
    last without bias), max-pooled over positions, then dropout."""

    def __init__(self, num_chars: int, embedding_size: int, config: CnnConfig, dropout_rate: float = 0.0):
        super().__init__()
        self.num_chars = num_chars
        self.conv1 = Conv1d(num_chars, config.l1_filters, config.l1_window_size)
        self.conv2 = Conv1d(config.l1_filters, config.l2_filters, config.l2_window_size)
        self.conv3 = Conv1d(config.l2_filters, embedding_size, config.lout_window_size, use_bias=False)
        self.dropout_rate = dropout_rate

    def forward(self, chars: torch.Tensor, *, train: bool = False, generator=None) -> torch.Tensor:
        """chars: [B, max_num_chars] int -> [B, D] float32 (the one-hot is
        float32, as the JAX package's, and so is every conv under AMP)."""
        x = F.one_hot(chars.long(), self.num_chars).float().transpose(1, 2)  # [B, C, L]
        x = self.conv1(x)
        x = self.conv2(torch.relu(x))
        x = self.conv3(torch.relu(x))  # [B, D, L']
        return dropout(x.amax(dim=-1), self.dropout_rate, train, generator)


class StrElementRepresentationModel(AbstractNeuralModel):
    """String node-label embedder with token, subtoken, bpe or char
    splitting. ``bpe`` counts whole tokens, trains a :class:`BpeVocabulary`
    of ``vocabulary_size`` entries and embeds the pieces as subtokens."""

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
        cnn_config: CnnConfig = CnnConfig(256, 3, 128, 3, 3),
        max_num_chars: int = 15,
    ):
        super().__init__()
        if token_splitting not in ("token", "subtoken", "bpe", "char"):
            raise ValueError(f"unknown token splitting {token_splitting!r}")
        self.splitting_kind = token_splitting
        self.embedding_size = embedding_size
        self.dropout_rate = dropout_rate
        if token_splitting in ("subtoken", "bpe"):
            self.max_num_subtokens = max_num_subtokens if max_num_subtokens is not None else 5
            self.subtoken_combination = subtoken_combination
        elif token_splitting == "char":
            self.cnn_config = cnn_config
            self.max_num_chars = max_num_chars
        if token_splitting != "char":
            self.max_vocabulary_size = vocabulary_size
            self.min_freq_threshold = min_freq_threshold

    def representation_size(self) -> int:
        return self.embedding_size

    def initialize_metadata(self) -> None:
        self.__tok_counter: Counter = Counter()

    def update_metadata_from(self, datapoint: str) -> None:
        if self.splitting_kind in ("token", "bpe"):
            self.__tok_counter[datapoint] += 1
        elif self.splitting_kind == "subtoken":
            self.__tok_counter.update(split_identifier_into_parts(datapoint))

    def finalize_metadata(self) -> None:
        if self.splitting_kind in ("token", "subtoken"):
            self.__vocabulary = Vocabulary.create_vocabulary(
                self.__tok_counter,
                max_size=self.max_vocabulary_size,
                count_threshold=self.min_freq_threshold,
            )
        elif self.splitting_kind == "bpe":
            self.__vocabulary = BpeVocabulary(self.max_vocabulary_size)
            self.__vocabulary.create_vocabulary(self.__tok_counter)
        else:
            self.__vocabulary = CharTensorizer(self.max_num_chars, lower_case_all=False, include_space=False)
        del self.__tok_counter

    @property
    def vocabulary(self) -> Union[Vocabulary, BpeVocabulary, CharTensorizer]:
        return self.__vocabulary

    def build_neural_module(self) -> torch.nn.Module:
        if self.splitting_kind == "token":
            return TokenUnitEmbedder(len(self.vocabulary), self.embedding_size, self.dropout_rate)
        if self.splitting_kind in ("subtoken", "bpe"):
            return SubtokenUnitEmbedder(
                len(self.vocabulary), self.embedding_size, self.dropout_rate,
                self.subtoken_combination,
            )
        return CharUnitEmbedder(
            self.vocabulary.num_chars_in_vocabulary(), self.embedding_size, self.cnn_config, self.dropout_rate
        )

    def tensorize(self, datapoint: str, return_str_rep: bool = False):
        """The label's ids; with ``return_str_rep``, also its string form
        (``bpe``: the pieces; ``char``: the chars kept; else the label)."""
        str_repr = datapoint
        if self.splitting_kind == "token":
            token_idxs = self.vocabulary.get_id_or_unk(datapoint)
        elif self.splitting_kind == "char":
            token_idxs = self.vocabulary.tensorize_str(datapoint)
            str_repr = datapoint[: self.vocabulary.max_char_length]
        elif self.splitting_kind == "bpe":
            if len(datapoint) == 0:
                datapoint = "<empty>"
            token_idxs = self.vocabulary.get_id_or_unk_for_text(datapoint)
            if return_str_rep:
                str_repr = self.vocabulary.tokenize(datapoint)
        else:
            subtoks = split_identifier_into_parts(datapoint)
            if len(subtoks) == 0:
                subtoks = [Vocabulary.get_unk()]
            token_idxs = self.vocabulary.get_id_or_unk_multiple(subtoks)
        return (token_idxs, str_repr) if return_str_rep else token_idxs

    def initialize_minibatch(self) -> Dict[str, Any]:
        return {"token_idxs": []}

    def extend_minibatch_with(self, tensorized_datapoint, partial_minibatch) -> bool:
        partial_minibatch["token_idxs"].append(tensorized_datapoint)
        return True

    def finalize_minibatch(self, accumulated_minibatch_data, pad_to: Optional[int] = None):
        items: List = accumulated_minibatch_data["token_idxs"]
        total = pad_to if pad_to is not None else len(items)
        if self.splitting_kind == "token":
            token_idxs = np.zeros(total, np.int32)
            token_idxs[: len(items)] = np.asarray(items, np.int32)
            return {"token_idxs": token_idxs}
        if self.splitting_kind == "char":
            chars = np.zeros((total, self.max_num_chars), np.int32)
            if items:
                chars[: len(items)] = np.stack(items, axis=0)
            return {"chars": chars}
        width = self.max_num_subtokens
        subtoken_idxs = np.zeros((total, width), np.int32)
        lengths = np.zeros(total, np.int32)
        for i, subtokens in enumerate(items):
            idxs = subtokens[:width]
            subtoken_idxs[i, : len(idxs)] = idxs
            lengths[i] = len(idxs)
        return {"token_idxs": subtoken_idxs, "lengths": lengths}
