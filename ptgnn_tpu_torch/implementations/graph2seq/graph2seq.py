"""Graph2Seq: encode a code graph, decode its method name with a copy
mechanism.

The decoder's memories are the GNN's output rows of the graph's backbone
nodes (the padded ``backbone_nodes`` reference set); its initial state is a
multi-head self-attention reduce over each graph's [input | output] node
rows. Decoder target rows align one to one with graph slots. Decoding
(:meth:`Graph2Seq.greedy_decode`, :meth:`Graph2Seq.beam_decode`) runs on
the module's device, CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import functools
import logging
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, TypedDict

import torch

from ptgnn_tpu_torch.core.iterators import ThreadedIterator
from ptgnn_tpu_torch.core.compiled_step import CompiledStep
from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.device import DeviceLike, resolve_device
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetwork, GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.structs import GraphBatch, GraphData, TensorizedGraphData, tree_to
from ptgnn_tpu_torch.nn.module import Module, init_parameters
from ptgnn_tpu_torch.reduceops import (
    AbstractVarSizedElementReduce,
    ElementsToSummaryRepresentationInput,
    MultiheadSelfAttentionVarSizedElementReduce,
    SimpleVarSizedElementReduce,
)
from ptgnn_tpu_torch.sequence.grucopydecoder import (
    DecoderData,
    GruCopyingDecoder,
    GruCopyingDecoderModel,
    TokenizedOutput,
)

LOGGER = logging.getLogger(__name__)


class CodeGraph2Seq(TypedDict):
    backbone_sequence: List[int]
    node_labels: List[str]
    edges: Dict[str, List[Tuple[int, int]]]
    method_name: List[str]


class TensorizedGraph2Seq(NamedTuple):
    encoder_data: TensorizedGraphData
    decoder_data: TokenizedOutput


class Graph2SeqModule(Module):
    """GNN, graph summariser (the decoder's initial states) and copy
    decoder, under the JAX package's param keys ``gnn``, ``summarizer`` and
    ``decoder``."""

    def __init__(self, gnn: GraphNeuralNetwork, decoder: GruCopyingDecoder,
                 summarizer: AbstractVarSizedElementReduce):
        super().__init__()
        self.gnn = gnn
        self.decoder = decoder
        self.summarizer = summarizer

    def encode(self, batch: GraphBatch, *, train: bool = False, generator: Optional[torch.Generator] = None):
        """(memories [M_pad, H], their graphs [M_pad] (padding G_pad), their
        mask, initial decoder states [G_pad, H], GNN metric accumulators).
        The initial states summarise every graph's [input | output] node rows,
        padding nodes masked (a padding graph gets a zero summary's
        projection)."""
        gnn_output, gnn_metrics = self.gnn(batch, train=train, generator=generator)
        memories = gnn_output.reference_rows("backbone_nodes")
        origin = gnn_output.node_graph_idx_reference["backbone_nodes"]
        memory_mask = gnn_output.reference_masks["backbone_nodes"]
        initial_states = self.summarizer(ElementsToSummaryRepresentationInput(
            element_embeddings=torch.cat([gnn_output.node_table("input"), gnn_output.node_table("output")], dim=-1),
            element_to_sample_map=gnn_output.node_to_graph_idx,
            num_samples=gnn_output.graph_mask.shape[0],
            mask=gnn_output.node_mask,
        ))
        return memories, origin, memory_mask, initial_states, gnn_metrics

    def forward(
        self,
        batch: GraphBatch,
        target_token_ids: torch.Tensor,
        target_lengths: torch.Tensor,
        copy_matrix: torch.Tensor,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """The decoder's copy-marginalised loss, and the metric accumulators."""
        memories, origin, memory_mask, initial_states, gnn_metrics = self.encode(
            batch, train=train, generator=generator)
        loss, dec_metrics = self.decoder(
            input_memories=memories,
            input_memories_origin_idx=origin,
            memory_mask=memory_mask,
            initial_states=initial_states,
            target_token_ids=target_token_ids,
            target_lengths=target_lengths,
            copy_matrix=copy_matrix,
            train=train,
            generator=generator,
        )
        return loss, {"loss_sum": loss, "num_mbs": 1, **dec_metrics, **gnn_metrics}

    def finalize_metrics(self, accumulated) -> Dict[str, Any]:
        return {"loss": accumulated.get("loss_sum", 0.0) / max(accumulated.get("num_mbs", 0), 1)}


class Graph2Seq(AbstractNeuralModel[CodeGraph2Seq, TensorizedGraph2Seq, Graph2SeqModule]):
    NUM_SUMMARIZATION_HEADS = 8

    def __init__(self, gnn_model: GraphNeuralNetworkModel, decoder: GruCopyingDecoderModel):
        super().__init__()
        self.__gnn_model = gnn_model
        self.__decoder_model = decoder

    @property
    def gnn_model(self) -> GraphNeuralNetworkModel:
        return self.__gnn_model

    @property
    def decoder_model(self) -> GruCopyingDecoderModel:
        return self.__decoder_model

    @staticmethod
    def __to_graph_data(datapoint: CodeGraph2Seq) -> Tuple[GraphData, List[str]]:
        graph_nodes = [label.lower() for label in datapoint["node_labels"]]
        return (
            GraphData(
                node_information=graph_nodes,
                edges={t: list(edges) for t, edges in datapoint["edges"].items()},
                reference_nodes={"backbone_nodes": datapoint["backbone_sequence"]},
            ),
            graph_nodes,
        )

    @staticmethod
    def __decoder_data(datapoint: CodeGraph2Seq, graph_nodes: List[str]) -> DecoderData:
        return DecoderData(
            input_elements=[graph_nodes[k] for k in datapoint["backbone_sequence"]],
            target_data=datapoint["method_name"],
        )

    def update_metadata_from(self, datapoint: CodeGraph2Seq) -> None:
        graph_data, graph_nodes = self.__to_graph_data(datapoint)
        self.__gnn_model.update_metadata_from(graph_data)
        self.__decoder_model.update_metadata_from(self.__decoder_data(datapoint, graph_nodes))

    def build_neural_module(self, device: DeviceLike = None, seed: int = 0) -> Graph2SeqModule:
        """The module with seeded random weights, on ``device`` (CUDA by
        default)."""
        device = resolve_device(device)
        gnn = self.__gnn_model.build_neural_module()
        width = gnn.input_node_state_dim + gnn.output_node_state_dim
        summarizer = MultiheadSelfAttentionVarSizedElementReduce(
            input_representation_size=width,
            hidden_size=width,
            output_representation_size=gnn.output_node_state_dim,
            num_heads=self.NUM_SUMMARIZATION_HEADS,
            query_representation_summarizer=SimpleVarSizedElementReduce("max"),
        )
        module = Graph2SeqModule(gnn, self.__decoder_model.build_neural_module(), summarizer)
        init_parameters(module, seed)
        return module.to(device)

    def tensorize(self, datapoint: CodeGraph2Seq) -> Optional[TensorizedGraph2Seq]:
        graph_data_raw, graph_nodes = self.__to_graph_data(datapoint)
        graph_data = self.__gnn_model.tensorize(graph_data_raw)
        if graph_data is None:
            return None
        return TensorizedGraph2Seq(
            encoder_data=graph_data,
            decoder_data=self.__decoder_model.tensorize(self.__decoder_data(datapoint, graph_nodes)),
        )

    def initialize_minibatch(self) -> Dict[str, Any]:
        return {
            "encoder_mb_data": self.__gnn_model.initialize_minibatch(),
            "decoder_mb_data": self.__decoder_model.initialize_minibatch(),
        }

    def can_add_to_minibatch(self, tensorized: TensorizedGraph2Seq, partial_minibatch) -> bool:
        return self.__gnn_model.can_add_to_minibatch(tensorized.encoder_data, partial_minibatch["encoder_mb_data"])

    def extend_minibatch_with(self, tensorized_datapoint: TensorizedGraph2Seq, partial_minibatch) -> bool:
        continue_adding = self.__gnn_model.extend_minibatch_with(
            tensorized_datapoint.encoder_data, partial_minibatch["encoder_mb_data"])
        continue_adding &= self.__decoder_model.extend_minibatch_with(
            tensorized_datapoint.decoder_data, partial_minibatch["decoder_mb_data"])
        return continue_adding

    def finalize_minibatch(self, accumulated_minibatch_data: Dict[str, Any]) -> Dict[str, Any]:
        encoder = self.__gnn_model.finalize_minibatch(accumulated_minibatch_data["encoder_mb_data"])
        padding = self.__gnn_model.padding
        decoder = self.__decoder_model.finalize_minibatch(
            accumulated_minibatch_data["decoder_mb_data"],
            max_targets=padding.max_graphs,
            memories_budget=padding.reference_budget("backbone_nodes"),
        )
        return {"batch": encoder["batch"], **decoder}

    def _decode_minibatches(
        self,
        data: List[CodeGraph2Seq],
        trained_network: Graph2SeqModule,
        decode_fn,
        max_minibatch_size: int,
        device: DeviceLike,
    ) -> List:
        """Encode each minibatch on ``device``, then ``decode_fn`` its
        decoder inputs. A sample dropped by the size caps gets None at its
        position: each sample's position rides through the minibatch
        iterator as its raw input, so equal duplicates cannot take each
        other's results."""
        device = resolve_device(device)
        trained_network.to(device).eval()
        encode = CompiledStep(trained_network.encode, device)
        indexed_stream = ThreadedIterator(((self.tensorize(d), i) for i, d in enumerate(data)), enabled=True)
        decoded: List = []
        survivor_idx: List[int] = []
        with torch.inference_mode():
            for mb_data, mb_indices in self.minibatch_iterator(
                (s for s in indexed_stream if s[0] is not None), max_minibatch_size=max_minibatch_size,
            ):
                input_concrete_values: List[str] = []
                for i in mb_indices:
                    sample = data[i]
                    input_concrete_values.extend(
                        sample["node_labels"][k].lower() for k in sample["backbone_sequence"])
                memories, origin, memory_mask, initial_states, _ = encode(tree_to(mb_data["batch"], device))
                survivor_idx.extend(mb_indices)
                decoded.extend(decode_fn(
                    input_concrete_values=input_concrete_values,
                    input_memories=memories,
                    input_memories_origin_idx=origin,
                    memory_mask=memory_mask,
                    initial_states=initial_states,
                    neural_module=trained_network.decoder,
                    num_real_targets=len(mb_indices),
                ))
        if len(decoded) == len(data):
            return decoded
        LOGGER.warning("decode: %d of %d samples were dropped by size caps; their results are None.",
                       len(data) - len(decoded), len(data))
        aligned: List = [None] * len(data)
        for i, result in zip(survivor_idx, decoded):
            aligned[i] = result
        return aligned

    def greedy_decode(
        self,
        data: List[CodeGraph2Seq],
        trained_network: Graph2SeqModule,
        max_minibatch_size: int = 50,
        device: DeviceLike = None,
    ) -> List[Optional[Tuple[List[str], float]]]:
        """Per sample (tokens, log-probability) of the greedy decode."""
        return self._decode_minibatches(
            data, trained_network, self.__decoder_model.greedy_decode, max_minibatch_size, device)

    def beam_decode(
        self,
        data: List[CodeGraph2Seq],
        trained_network: Graph2SeqModule,
        beam_size: int = 5,
        max_minibatch_size: int = 50,
        device: DeviceLike = None,
    ) -> List[Optional[List[Tuple[List[str], float]]]]:
        """Per sample the ``beam_size`` best sequences as (tokens,
        log-probability), best first."""
        return self._decode_minibatches(
            data, trained_network,
            functools.partial(self.__decoder_model.beam_decode, beam_size=beam_size),
            max_minibatch_size, device,
        )
