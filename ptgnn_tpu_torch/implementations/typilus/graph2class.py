"""Graph2Class (Typilus): classify graph "supernodes" into type classes.

The neural side runs over a statically shaped GraphBatch plus a padded
``[supernode_budget]`` target-class array; the cross-entropy and accuracy
are masked over valid supernode slots. Serving (``predict``,
``report_accuracy``) runs under ``torch.inference_mode()`` on the module's
device, CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import logging
from collections import Counter
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple, TypedDict

import numpy as np
import torch

from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.device import DeviceLike, resolve_device
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetwork, GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.structs import GraphBatch, GraphData, TensorizedGraphData
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Linear
from ptgnn_tpu_torch.nn.module import Module, init_parameters
from ptgnn_tpu_torch.utils.text import Vocabulary

LOGGER = logging.getLogger(__name__)


class SuperNodeData(TypedDict, total=False):
    name: str
    annotation: Optional[str]


class TypilusGraph(TypedDict):
    nodes: List[str]
    edges: Dict[str, Dict[str, List[int]]]
    token_sequence: List[int]  # JSON key: "token-sequence"
    supernodes: Dict[str, SuperNodeData]
    filename: str


Prediction = Tuple[TypilusGraph, Dict[int, Tuple[str, float]]]


class TensorizedGraph2ClassSample(NamedTuple):
    graph: TensorizedGraphData
    supernode_target_classes: List[int]


IGNORED_TYPES = {
    "typing.Any", "Any", "", "typing.NoReturn", "NoReturn", "nothing", "None",
    "T", "_T", "_T0", "_T1", "_T2", "_T3", "_T4", "_T5", "_T6", "_T7",
}


class Graph2ClassModule(Module):
    """GNN + linear supernode classifier."""

    def __init__(self, gnn: GraphNeuralNetwork, num_target_classes: int):
        super().__init__()
        self.gnn = gnn
        self.num_target_classes = num_target_classes
        self.node_to_class = Linear(
            gnn.output_node_state_dim,
            num_target_classes,
            use_bias=True,
            weight_init=init.uniform(0.0, 1.0),
            bias_init=init.zeros(),
        )

    def _logits(self, batch: GraphBatch, *, train: bool, generator: Optional[torch.Generator] = None):
        gnn_output, gnn_metrics = self.gnn(batch, train=train, generator=generator)
        mask = gnn_output.reference_masks["supernodes"]  # [R_pad]
        reps = gnn_output.reference_rows("supernodes")  # [R_pad, D]
        logits = self.node_to_class(reps)
        return logits, gnn_output.reference_nodes_graph_idx["supernodes"], mask, gnn_metrics

    def forward(
        self,
        batch: GraphBatch,
        target_classes: torch.Tensor,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """Masked mean cross-entropy over valid supernode slots; returns
        (loss, metric accumulators). ``train=True`` applies dropout, drawn from
        ``generator``, and gives the training loss."""
        logits, _, mask, gnn_metrics = self._logits(batch, train=train, generator=generator)
        logp = torch.log_softmax(logits.float(), dim=-1)
        safe_targets = torch.where(mask, target_classes, torch.zeros_like(target_classes)).long()
        nll = -logp.gather(1, safe_targets[:, None])[:, 0]
        num_valid = mask.sum().clamp_min(1)
        loss = torch.where(mask, nll, torch.zeros((), device=nll.device)).sum() / num_valid.float()
        predictions = logits.argmax(dim=-1)
        metrics = {
            "sum_accuracy": ((predictions == safe_targets) & mask).sum(),
            "num_samples": mask.sum(),
            **gnn_metrics,
        }
        return loss, metrics

    def predict_probs(self, batch: GraphBatch):
        """(max prob, argmax class, supernode graph idx, valid mask) per slot."""
        logits, graph_idx, mask, _ = self._logits(batch, train=False)
        probs = torch.softmax(logits.float(), dim=-1)
        top, arg = probs.max(dim=-1)
        return top, arg, graph_idx, mask

    def finalize_metrics(self, accumulated) -> Dict[str, Any]:
        num = max(accumulated.get("num_samples", 0), 1)
        return {"Accuracy": accumulated.get("sum_accuracy", 0) / num}


class Graph2Class(
    AbstractNeuralModel[TypilusGraph, TensorizedGraph2ClassSample, Graph2ClassModule]
):
    def __init__(
        self,
        gnn_model: GraphNeuralNetworkModel,
        max_num_classes: int = 100,
        try_simplify_unks: bool = True,
    ):
        super().__init__()
        self.__gnn_model = gnn_model
        self.max_num_classes = max_num_classes
        self.__try_simplify_unks = try_simplify_unks
        self.__tensorize_samples_with_no_annotation = False
        self.__tensorize_keep_original_supernode_idx = False

    @property
    def gnn_model(self) -> GraphNeuralNetworkModel:
        return self.__gnn_model

    def __convert(self, raw: TypilusGraph) -> Tuple[GraphData, List[str]]:
        """Typilus-schema JSON graph -> GraphData plus its labeled supernodes
        (annotation present, or "??" when keeping unlabeled ones; ignored
        types dropped)."""
        edges = {
            kind: [(int(src), dst) for src, dsts in nested.items() for dst in dsts]
            for kind, nested in raw["edges"].items()
        }
        keep_unlabeled = self.__tensorize_samples_with_no_annotation
        labeled_ids: List[int] = []
        labels: List[str] = []
        for raw_idx, info in raw["supernodes"].items():
            label = info.get("annotation")
            if label in IGNORED_TYPES or (label is None and not keep_unlabeled):
                continue
            labeled_ids.append(int(raw_idx))
            labels.append("??" if label is None else label)
        graph = GraphData(
            node_information=raw["nodes"],
            edges=edges,
            reference_nodes={"token-sequence": raw["token-sequence"], "supernodes": labeled_ids},
        )
        return graph, labels

    # ---- metadata ----
    def initialize_metadata(self) -> None:
        self.__target_class_counter: Counter = Counter()

    def update_metadata_from(self, datapoint: TypilusGraph) -> None:
        graph_data, target_classes = self.__convert(datapoint)
        self.__gnn_model.update_metadata_from(graph_data)
        self.__target_class_counter.update(target_classes)

    def finalize_metadata(self) -> None:
        self.__target_vocab = Vocabulary.create_vocabulary(
            self.__target_class_counter, max_size=self.max_num_classes + 1
        )
        del self.__target_class_counter

    @property
    def target_vocab(self) -> Vocabulary:
        return self.__target_vocab

    def build_neural_module(self, device: DeviceLike = None, seed: int = 0) -> Graph2ClassModule:
        """The module with seeded random weights, on ``device`` (CUDA by
        default)."""
        device = resolve_device(device)
        module = Graph2ClassModule(
            gnn=self.__gnn_model.build_neural_module(),
            num_target_classes=len(self.__target_vocab),
        )
        init_parameters(module, seed)
        return module.to(device)

    # ---- tensorization ----
    def tensorize(self, datapoint: TypilusGraph) -> Optional[TensorizedGraph2ClassSample]:
        graph_data, target_classes = self.__convert(datapoint)
        if len(target_classes) == 0:
            return None
        graph_tensorized_data = self.__gnn_model.tensorize(graph_data)
        if graph_tensorized_data is None:
            return None
        target_class_ids = []
        for target_cls in target_classes:
            if self.__try_simplify_unks and self.__target_vocab.is_unk(target_cls):
                generic_start = target_cls.find("[")
                if generic_start != -1:
                    target_cls = target_cls[:generic_start]
            target_class_ids.append(self.__target_vocab.get_id_or_unk(target_cls))
        return TensorizedGraph2ClassSample(
            graph=graph_tensorized_data, supernode_target_classes=target_class_ids
        )

    # ---- minibatching ----
    def initialize_minibatch(self) -> Dict[str, Any]:
        return {
            "graph_mb_data": self.__gnn_model.initialize_minibatch(),
            "target_classes": [],
            "original_supernode_idxs": [],
        }

    def can_add_to_minibatch(self, tensorized, partial_minibatch) -> bool:
        return self.__gnn_model.can_add_to_minibatch(
            tensorized.graph, partial_minibatch["graph_mb_data"]
        )

    def extend_minibatch_with(self, tensorized_datapoint, partial_minibatch) -> bool:
        partial_minibatch["target_classes"].extend(tensorized_datapoint.supernode_target_classes)
        if self.__tensorize_keep_original_supernode_idx:
            partial_minibatch["original_supernode_idxs"].extend(
                tensorized_datapoint.graph.reference_nodes["supernodes"].tolist()
            )
        return self.__gnn_model.extend_minibatch_with(
            tensorized_datapoint.graph, partial_minibatch["graph_mb_data"]
        )

    def finalize_minibatch(self, accumulated_minibatch_data: Dict[str, Any]) -> Dict[str, Any]:
        graph_data = self.__gnn_model.finalize_minibatch(accumulated_minibatch_data["graph_mb_data"])
        budget = self.__gnn_model.padding.reference_budget("supernodes")
        targets = np.zeros(budget, np.int32)
        given = accumulated_minibatch_data["target_classes"]
        targets[: len(given)] = given
        out = {"batch": graph_data["batch"], "target_classes": targets}
        if self.__tensorize_keep_original_supernode_idx:
            out["original_supernode_idxs"] = accumulated_minibatch_data["original_supernode_idxs"]
        return out

    # ---- evaluation / prediction ----
    def report_accuracy(
        self,
        dataset: Iterator[TypilusGraph],
        trained_network: Graph2ClassModule,
        max_minibatch_size: int = 50,
        device: DeviceLike = None,
    ) -> float:
        """Test accuracy counting UNK predictions as wrong."""
        device = resolve_device(device)
        trained_network.to(device).eval()
        unk_class_id = self.__target_vocab.get_id_or_unk(Vocabulary.get_unk())
        num_correct, num_elements = 0, 0
        with torch.inference_mode():
            for mb_data, _ in self.minibatch_iterator(
                self.tensorize_dataset(iter(dataset)), max_minibatch_size=max_minibatch_size
            ):
                _, predictions, _, mask = trained_network.predict_probs(mb_data["batch"].to(device))
                predictions = predictions.cpu().numpy()
                mask = mask.cpu().numpy()
                targets = mb_data["target_classes"]
                valid = np.where(mask)[0]
                num_elements += len(valid)
                num_correct += int(
                    np.sum((predictions[valid] == targets[valid]) & (targets[valid] != unk_class_id))
                )
        return num_correct / max(num_elements, 1)

    def predict(
        self,
        data: Iterator[TypilusGraph],
        trained_network: Graph2ClassModule,
        max_minibatch_size: int = 50,
        device: DeviceLike = None,
    ) -> Iterator[Prediction]:
        """Streaming per-graph type suggestions."""
        device = resolve_device(device)
        trained_network.to(device).eval()
        try:
            self.__tensorize_samples_with_no_annotation = True
            self.__tensorize_keep_original_supernode_idx = True
            for mb_data, original_datapoints in self.minibatch_iterator(
                self.tensorize_dataset(iter(data), return_input_data=True, parallelize=False),
                max_minibatch_size=max_minibatch_size,
                parallelize=False,
            ):
                with torch.inference_mode():
                    probs, predictions, graph_idxs, mask = (
                        x.cpu().numpy()
                        for x in trained_network.predict_probs(mb_data["batch"].to(device))
                    )
                supernode_idxs = mb_data["original_supernode_idxs"]
                valid = np.where(mask)[0]
                current_graph_idx = 0
                graph_preds: Dict[int, Tuple[str, float]] = {}
                for slot, supernode_idx in zip(valid, supernode_idxs):
                    graph_idx = int(graph_idxs[slot])
                    if graph_idx != current_graph_idx:
                        yield original_datapoints[current_graph_idx], graph_preds
                        current_graph_idx = graph_idx
                        graph_preds = {}
                    predicted_type = self.__target_vocab.get_name_for_id(int(predictions[slot]))
                    graph_preds[supernode_idx] = (predicted_type, float(probs[slot]))
                yield original_datapoints[current_graph_idx], graph_preds
        finally:
            self.__tensorize_samples_with_no_annotation = False
            self.__tensorize_keep_original_supernode_idx = False
