"""VarMisuse's node embedder: the string label's embedding, then an
is-candidate bit."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.graph.embedders import StrElementRepresentationModel


class CandidateNodeAnnotationModule(torch.nn.Module):
    """[label embedding | is_candidate] per node. The embedder sits under the
    JAX package's param key ``embedder``."""

    def __init__(self, node_embeddings_module: torch.nn.Module):
        super().__init__()
        self.embedder = node_embeddings_module

    def forward(self, node_data: Dict[str, Any], is_candidate: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embeddings = self.embedder(**node_data, train=train, generator=generator)
        return torch.cat([embeddings, is_candidate[:, None].to(embeddings.dtype)], dim=-1)


class CandidateNodeAnnotationModel(AbstractNeuralModel):
    """Host side: a node is a (label, is_candidate) pair; the label takes
    ``embedding_size - 1`` columns of a :class:`StrElementRepresentationModel`
    built with ``kwargs``."""

    def __init__(self, embedding_size: int = 128, **kwargs):
        super().__init__()
        self.__str_node_annotation = StrElementRepresentationModel(embedding_size=embedding_size - 1, **kwargs)

    def update_metadata_from(self, datapoint: Tuple[str, bool]) -> None:
        self.__str_node_annotation.update_metadata_from(datapoint[0])

    def build_neural_module(self) -> CandidateNodeAnnotationModule:
        return CandidateNodeAnnotationModule(self.__str_node_annotation.build_neural_module())

    def tensorize(self, datapoint: Tuple[str, bool]) -> Tuple[Any, bool]:
        return self.__str_node_annotation.tensorize(datapoint[0]), datapoint[1]

    def initialize_minibatch(self) -> Dict[str, Any]:
        return {"node_data": self.__str_node_annotation.initialize_minibatch(), "is_candidate": []}

    def extend_minibatch_with(self, tensorized_datapoint, partial_minibatch) -> bool:
        continue_extending = self.__str_node_annotation.extend_minibatch_with(
            tensorized_datapoint[0], partial_minibatch["node_data"]
        )
        partial_minibatch["is_candidate"].append(tensorized_datapoint[1])
        return continue_extending

    def finalize_minibatch(self, accumulated_minibatch_data: Dict[str, Any],
                           pad_to: Optional[int] = None) -> Dict[str, Any]:
        flags = accumulated_minibatch_data["is_candidate"]
        is_candidate = np.zeros(pad_to if pad_to is not None else len(flags), np.float32)
        is_candidate[: len(flags)] = flags
        return {
            "node_data": self.__str_node_annotation.finalize_minibatch(
                accumulated_minibatch_data["node_data"], pad_to=pad_to
            ),
            "is_candidate": is_candidate,
        }

    def representation_size(self) -> int:
        return self.__str_node_annotation.representation_size() + 1
