"""PPI multi-label node classification.

Per-node BCE-with-logits summed over the labels and averaged over valid
(non-padding) nodes; micro precision, recall and F1 per batch, accumulated
weighted by the batch's node count. Serving (``report_metrics``) runs under
``torch.inference_mode()`` on the module's device, CUDA unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch

from ptgnn_tpu_torch.core.compiled_step import CompiledStep
from ptgnn_tpu_torch.core.data import enforce_not_None
from ptgnn_tpu_torch.core.metrics import MetricsAccumulator
from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.device import DeviceLike, resolve_device
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetwork, GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.structs import GraphBatch, GraphData, TensorizedGraphData
from ptgnn_tpu_torch.implementations.ppi.dataloader import PPIGraphSample
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Linear
from ptgnn_tpu_torch.nn.module import Module, init_parameters


class TensorizedPPIData(NamedTuple):
    gnn_data: TensorizedGraphData
    targets: np.ndarray


class PPIClassification(Module):
    """GNN + a per-node linear map to the label logits."""

    def __init__(self, gnn: GraphNeuralNetwork, num_target_classes: int):
        super().__init__()
        self.gnn = gnn
        self.num_target_classes = num_target_classes
        self.to_logits = Linear(
            gnn.output_node_state_dim,
            num_target_classes,
            use_bias=True,
            weight_init=init.xavier_uniform(),
            bias_init=init.zeros(),
        )

    def logits(self, batch: GraphBatch, *, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """([max_nodes, C] float32 logits, [max_nodes] node mask, GNN metrics)."""
        gnn_output, gnn_metrics = self.gnn(batch, train=train, generator=generator)
        logits = self.to_logits(gnn_output.node_table("output")).float()
        return logits, gnn_output.node_mask, gnn_metrics

    def forward(
        self,
        batch: GraphBatch,
        targets: torch.Tensor,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """targets: [max_nodes, C] bool. Returns (loss, metric accumulators);
        ``train=True`` applies dropout, drawn from ``generator``."""
        logits, node_mask, gnn_metrics = self.logits(batch, train=train, generator=generator)
        predictions = torch.sigmoid(logits) >= 0.5
        valid = node_mask[:, None]
        tp = (predictions & targets & valid).sum()
        fp = (predictions & ~targets & valid).sum()
        fn = (~predictions & targets & valid).sum()
        precision = tp / (tp + fp + 1e-10)
        recall = tp / (tp + fn + 1e-10)
        fscore = 2 * precision * recall / (precision + recall + 1e-10)
        num_samples = node_mask.sum()

        per_element = logits.clamp_min(0.0) - logits * targets.float() + torch.log1p(torch.exp(-logits.abs()))
        per_node = per_element.sum(dim=-1)
        loss = torch.where(node_mask, per_node, torch.zeros((), device=per_node.device)).sum() / (
            num_samples.clamp_min(1).float()
        )
        nf = num_samples.float()
        metrics = {
            "sum_f1": fscore * nf,
            "sum_pr": precision * nf,
            "sum_re": recall * nf,
            "num_samples": num_samples,
            **gnn_metrics,
        }
        return loss, metrics

    def finalize_metrics(self, accumulated) -> Dict[str, Any]:
        num = max(accumulated.get("num_samples", 0), 1)
        return {
            "f1_score": accumulated.get("sum_f1", 0.0) / num,
            "pr_score": accumulated.get("sum_pr", 0.0) / num,
            "re_score": accumulated.get("sum_re", 0.0) / num,
        }


class PPIMulticlassClassification(
    AbstractNeuralModel[PPIGraphSample, TensorizedPPIData, PPIClassification]
):
    # The minibatch entries of one row per node, which node sharding permutes
    # with the nodes under a reorder (parallel/node_sharding.py).
    node_aligned_minibatch_keys = ("targets",)

    def __init__(self, gnn_model: GraphNeuralNetworkModel):
        super().__init__()
        self.__gnn_model = gnn_model

    @property
    def gnn_model(self) -> GraphNeuralNetworkModel:
        return self.__gnn_model

    def __to_graph_data(self, datapoint: PPIGraphSample) -> GraphData:
        return GraphData(
            node_information=list(datapoint.node_features),
            edges={f"e{i}": [tuple(e) for e in a] for i, a in enumerate(datapoint.adjacency_lists)},
            reference_nodes={},
        )

    # ---- metadata ----
    def initialize_metadata(self) -> None:
        self.__num_target_labels: Optional[int] = None

    def update_metadata_from(self, datapoint: PPIGraphSample) -> None:
        self.__gnn_model.update_metadata_from(self.__to_graph_data(datapoint))
        if self.__num_target_labels is None:
            self.__num_target_labels = datapoint.node_labels.shape[1]
        elif self.__num_target_labels != datapoint.node_labels.shape[1]:
            raise ValueError("All samples should have the same number of labels.")

    def build_neural_module(self, device: DeviceLike = None, seed: int = 0) -> PPIClassification:
        """The module with seeded random weights, on ``device`` (CUDA by
        default)."""
        device = resolve_device(device)
        module = PPIClassification(
            self.__gnn_model.build_neural_module(), enforce_not_None(self.__num_target_labels)
        )
        init_parameters(module, seed)
        return module.to(device)

    # ---- tensorization and minibatching ----
    def tensorize(self, datapoint: PPIGraphSample) -> Optional[TensorizedPPIData]:
        graph_tensors = self.__gnn_model.tensorize(self.__to_graph_data(datapoint))
        if graph_tensors is None:
            return None
        return TensorizedPPIData(graph_tensors, datapoint.node_labels)

    def initialize_minibatch(self) -> Dict[str, Any]:
        return {"graph_data": self.__gnn_model.initialize_minibatch(), "labels": []}

    def can_add_to_minibatch(self, tensorized, partial_minibatch) -> bool:
        return self.__gnn_model.can_add_to_minibatch(tensorized.gnn_data, partial_minibatch["graph_data"])

    def extend_minibatch_with(self, tensorized_datapoint, partial_minibatch) -> bool:
        continue_adding = self.__gnn_model.extend_minibatch_with(
            tensorized_datapoint.gnn_data, partial_minibatch["graph_data"]
        )
        partial_minibatch["labels"].append(tensorized_datapoint.targets)
        return continue_adding

    def finalize_minibatch(self, accumulated_minibatch_data: Dict[str, Any]) -> Dict[str, Any]:
        """{"batch": GraphBatch, "targets": [max_nodes, C] bool}, the targets
        padded with False rows to the node budget."""
        graph_data = self.__gnn_model.finalize_minibatch(accumulated_minibatch_data["graph_data"])
        num_labels = enforce_not_None(self.__num_target_labels)
        padded = np.zeros((self.__gnn_model.padding.max_nodes, num_labels), bool)
        labels = accumulated_minibatch_data["labels"]
        if labels:
            labels = np.concatenate(labels, axis=0)
            padded[: len(labels)] = labels
        return {"batch": graph_data["batch"], "targets": padded}

    # ---- evaluation ----
    def report_metrics(
        self,
        dataset: Iterable[PPIGraphSample],
        trained_network: PPIClassification,
        max_minibatch_size: int = 50,
        device: DeviceLike = None,
    ) -> Dict[str, float]:
        """Micro F1, precision and recall over ``dataset``."""
        device = resolve_device(device)
        trained_network.to(device).eval()
        forward = CompiledStep(trained_network, device)
        acc = MetricsAccumulator()
        with torch.inference_mode():
            for mb_data, _ in self.minibatch_iterator(
                self.tensorize_dataset(iter(dataset)), max_minibatch_size=max_minibatch_size
            ):
                _, metrics = forward(mb_data["batch"].to(device), torch.from_numpy(mb_data["targets"]).to(device))
                acc.update(metrics)
        return trained_network.finalize_metrics(acc.totals())
