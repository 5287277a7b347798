"""VarMisuse: score each graph's candidate nodes against its slot node.

A per-slot log-softmax over the padded candidate reference set, by masked
segment ops (``ops/segment.py``). Vocabulary nodes, one per distinct
identifier subtoken, join the token nodes that contain them through derived
"SubtokenOf" edges, added to every graph on the host. Evaluation
(``report_accuracy``) runs under ``torch.inference_mode()`` on the module's
device, CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import re
from itertools import chain
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple, TypedDict

import numpy as np
import torch

from ptgnn_tpu_torch.core.metrics import MetricsAccumulator
from ptgnn_tpu_torch.core.compiled_step import CompiledStep
from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.device import DeviceLike, resolve_device
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetwork, GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.structs import GraphBatch, GraphData, TensorizedGraphData, tree_to
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Linear
from ptgnn_tpu_torch.nn.module import Module, init_parameters
from ptgnn_tpu_torch.ops.segment import masked_take, segment_argmax, segment_log_softmax
from ptgnn_tpu_torch.utils.text import split_identifier_into_parts


class VarMisuseGraph(TypedDict):
    Edges: Dict[str, List[Tuple[int, int]]]
    NodeLabels: Dict[str, str]
    NodeTypes: Dict[str, str]


class SymbolCandidate(TypedDict):
    SymbolDummyNode: int
    SymbolName: str
    IsCorrect: bool


class VarMisuseSample(TypedDict):
    ContextGraph: VarMisuseGraph
    slotTokenIdx: int
    SlotDummyNode: int
    SymbolCandidates: List[SymbolCandidate]


class TensorizedVarMisuseSample(NamedTuple):
    graph: TensorizedGraphData
    target_candidate_node_idx: int
    num_candidate_nodes: int


class VarMisuseGraphModel(Module):
    """GNN + a bias-free linear scorer of [candidate state | slot state].
    One slot per graph, as the data guarantees."""

    def __init__(self, gnn: GraphNeuralNetwork):
        super().__init__()
        self.gnn = gnn
        self.candidate_scores = Linear(2 * gnn.output_node_state_dim, 1, use_bias=False,
                                       weight_init=init.kaiming_uniform())

    def forward(
        self,
        batch: GraphBatch,
        correct_candidate_idxs: torch.Tensor,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """``correct_candidate_idxs``: [G_pad] indices into the padded
        candidate reference array (padding rows are masked by the slot
        mask). Returns the mean negative log-likelihood of the correct
        candidates and the metric accumulators."""
        gnn_output, gnn_metrics = self.gnn(batch, train=train, generator=generator)
        cand_graph = gnn_output.node_graph_idx_reference["candidate_nodes"]  # [C_pad], padding G_pad
        cand_mask = gnn_output.reference_masks["candidate_nodes"]
        slot_mask = gnn_output.reference_masks["slot_node_idx"]  # [G_pad]: row i is graph i's slot

        # Only the candidate and slot rows are read, never the node table.
        cand_reps = gnn_output.reference_rows("candidate_nodes")  # [C_pad, H]
        slot_reps = gnn_output.reference_rows("slot_node_idx")  # [G_pad, H]
        slot_per_cand = masked_take(slot_reps, cand_graph, 0.0)  # [C_pad, H]

        num_graphs = gnn_output.graph_mask.shape[0]
        scores = self.candidate_scores(torch.cat([cand_reps, slot_per_cand], dim=-1))[:, 0].float()
        logprobs = segment_log_softmax(scores, cand_graph, num_graphs, mask=cand_mask)

        safe_correct = torch.where(slot_mask, correct_candidate_idxs, torch.zeros_like(correct_candidate_idxs))
        correct_logprobs = masked_take(logprobs, safe_correct, 0.0)
        num_slots = slot_mask.sum().clamp_min(1)
        zero = torch.zeros((), dtype=correct_logprobs.dtype, device=correct_logprobs.device)
        loss = -torch.where(slot_mask, correct_logprobs, zero).sum() / num_slots.float()

        argmax = segment_argmax(scores, cand_graph, num_graphs, mask=cand_mask)  # [G_pad]
        correct = (argmax == safe_correct) & slot_mask
        metrics = {"sum_acc": correct.sum(), "num_samples": slot_mask.sum(), **gnn_metrics}
        return loss, metrics

    def finalize_metrics(self, accumulated) -> Dict[str, Any]:
        return {"Accuracy": accumulated.get("sum_acc", 0) / max(accumulated.get("num_samples", 0), 1)}


class VarMisuseModel(AbstractNeuralModel[VarMisuseSample, TensorizedVarMisuseSample, VarMisuseGraphModel]):
    IDENTIFIER_REGEX = re.compile("[a-zA-Z][a-zA-Z0-9]*")

    def __init__(self, gnn_model: GraphNeuralNetworkModel):
        super().__init__()
        self.__gnn_model = gnn_model

    @property
    def gnn_model(self) -> GraphNeuralNetworkModel:
        return self.__gnn_model

    @classmethod
    def __add_subtoken_vocab_nodes(cls, graph: GraphData) -> None:
        """Append one vocabulary node per distinct subtoken of the graph's
        identifier tokens (the NextToken backbone, in sorted order, so the
        derived numbering is deterministic), and a SubtokenOf edge from each
        vocabulary node to every token node that contains its subtoken."""
        backbone = sorted(set(chain(*graph.edges.get("NextToken", []))))
        containing_tokens: Dict[str, List[int]] = {}
        for node_idx in backbone:
            text = graph.node_information[node_idx][0]
            if not cls.IDENTIFIER_REGEX.match(text):
                continue
            for part in split_identifier_into_parts(text):
                containing_tokens.setdefault(part, []).append(node_idx)

        subtoken_edges: List[Tuple[int, int]] = []
        for part, token_nodes in containing_tokens.items():
            vocab_node = len(graph.node_information)
            graph.node_information.append((part, False))
            subtoken_edges.extend((vocab_node, t) for t in token_nodes)
        graph.edges["SubtokenOf"] = subtoken_edges

    def update_metadata_from(self, datapoint: VarMisuseSample) -> None:
        graph = datapoint["ContextGraph"]
        graph_data = GraphData(
            node_information=[(graph["NodeLabels"][str(i)], False) for i in range(len(graph["NodeLabels"]))],
            edges={t: list(e) for t, e in graph["Edges"].items()},
            # The reference sets are declared empty so the GNN registers
            # their names; they are filled at tensorize time.
            reference_nodes={"candidate_nodes": [], "slot_node_idx": []},
        )
        self.__add_subtoken_vocab_nodes(graph_data)
        self.__gnn_model.update_metadata_from(graph_data)

    def build_neural_module(self, device: DeviceLike = None, seed: int = 0) -> VarMisuseGraphModel:
        """The module with seeded random weights, on ``device`` (CUDA by
        default)."""
        device = resolve_device(device)
        module = VarMisuseGraphModel(self.__gnn_model.build_neural_module())
        init_parameters(module, seed)
        return module.to(device)

    def tensorize(self, datapoint: VarMisuseSample) -> Optional[TensorizedVarMisuseSample]:
        graph = datapoint["ContextGraph"]
        all_correct_slots = [i for i, c in enumerate(datapoint["SymbolCandidates"]) if c["IsCorrect"]]
        if len(all_correct_slots) != 1:
            raise ValueError(f"a sample needs exactly one correct candidate, not {len(all_correct_slots)}")

        candidate_node_ids = {s["SymbolDummyNode"] for s in datapoint["SymbolCandidates"]}
        graph_data = GraphData(
            node_information=[
                (graph["NodeLabels"][str(i)], i in candidate_node_ids) for i in range(len(graph["NodeLabels"]))
            ],
            edges={t: list(e) for t, e in graph["Edges"].items()},
            reference_nodes={
                "candidate_nodes": [s["SymbolDummyNode"] for s in datapoint["SymbolCandidates"]],
                "slot_node_idx": [datapoint["SlotDummyNode"]],
            },
        )
        self.__add_subtoken_vocab_nodes(graph_data)
        tensorized_graph_data = self.__gnn_model.tensorize(graph_data)
        if tensorized_graph_data is None:
            return None
        return TensorizedVarMisuseSample(
            graph=tensorized_graph_data,
            target_candidate_node_idx=all_correct_slots[0],
            num_candidate_nodes=len(datapoint["SymbolCandidates"]),
        )

    def initialize_minibatch(self) -> Dict[str, Any]:
        return {
            "graph_data": self.__gnn_model.initialize_minibatch(),
            "correct_candidate_idxs": [],
            "total_num_candidate_nodes": 0,
        }

    def can_add_to_minibatch(self, tensorized, partial_minibatch) -> bool:
        return self.__gnn_model.can_add_to_minibatch(tensorized.graph, partial_minibatch["graph_data"])

    def extend_minibatch_with(self, tensorized_datapoint, partial_minibatch) -> bool:
        continue_adding = self.__gnn_model.extend_minibatch_with(
            tensorized_datapoint.graph, partial_minibatch["graph_data"]
        )
        partial_minibatch["correct_candidate_idxs"].append(
            tensorized_datapoint.target_candidate_node_idx + partial_minibatch["total_num_candidate_nodes"]
        )
        partial_minibatch["total_num_candidate_nodes"] += tensorized_datapoint.num_candidate_nodes
        return continue_adding

    def finalize_minibatch(self, accumulated_minibatch_data: Dict[str, Any]) -> Dict[str, Any]:
        graph_data = self.__gnn_model.finalize_minibatch(accumulated_minibatch_data["graph_data"])
        correct = np.zeros(self.__gnn_model.padding.max_graphs, np.int32)
        given = accumulated_minibatch_data["correct_candidate_idxs"]
        correct[: len(given)] = given
        return {"batch": graph_data["batch"], "correct_candidate_idxs": correct}

    def report_accuracy(
        self,
        dataset: Iterator[VarMisuseSample],
        trained_network: VarMisuseGraphModel,
        max_minibatch_size: int = 50,
        device: DeviceLike = None,
    ) -> float:
        """The share of samples whose correct candidate scores highest."""
        device = resolve_device(device)
        trained_network.to(device).eval()
        forward = CompiledStep(trained_network, device)
        acc = MetricsAccumulator()
        with torch.inference_mode():
            for mb_data, _ in self.minibatch_iterator(
                self.tensorize_dataset(iter(dataset)), max_minibatch_size=max_minibatch_size
            ):
                _, metrics = forward(**tree_to(mb_data, device), train=False)
                acc.update(metrics)
        return trained_network.finalize_metrics(acc.totals())["Accuracy"]
