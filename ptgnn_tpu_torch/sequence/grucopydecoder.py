"""GRU sequence decoder with a copy mechanism over variable-sized memory sets:
the counterpart of the JAX package's ``sequence/grucopydecoder.py``.

The joint vocabulary-or-copy distribution is a per-(sample, step) segment
log-softmax over the padded memories, normalised together with the
vocabulary scores and the total copy score. Memories are a padded ``[M_pad,
D]`` array with ``origin_idx`` and ``mask`` (a padding memory carries origin
``B_pad`` and adds nothing to any softmax), and the copyable positions are a
dense boolean ``copy_matrix [M_pad, S-1]``: entry (m, t) says memory m's
string equals its sample's target token t+1. The loss that marginalises over
copy positions is one masked segment logsumexp.

Numerics as in the JAX package: -inf for impossible actions, an empty copy
set gives a -inf total copy score, scores accumulate in float32 (under bf16
AMP too). The segment ops are stock PyTorch (``ops/segment.py``); the JAX
package leaves them to XLA.

Decoding (:meth:`GruCopyingDecoderModel.greedy_decode` and
:meth:`~GruCopyingDecoderModel.beam_decode`) runs on the memories' device:
the host numbers one copy group per distinct (sample, string), and a loop
over ``max_seq_len`` steps keeps every state on the device; the emitted ids
and log-probabilities reach the host after the last step. Beams fold into
the batch axis: beam j of sample b is row ``j * B_pad + b``. The loop is a
compiled step (``core/compiled_step.py``), as the JAX package jits its
``lax.scan`` per static shape: one CUDA graph per (batch, memory and group
budgets, beam count, sampling or not), kept on the decoder model
(:meth:`GruCopyingDecoderModel.decode_loop`); the copy groups' tensors are
its inputs, and the group budget is a power of two, so a stream of batches
has few signatures.
"""
from __future__ import annotations

import functools
import logging
import math
from collections import Counter
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ptgnn_tpu_torch.core.compiled_step import CompiledStep, canonical_device
from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import GRU, Embedding, Linear, dropout
from ptgnn_tpu_torch.ops.segment import segment_log_softmax, segment_logsumexp, segment_sum, take_rows
from ptgnn_tpu_torch.utils.text import Vocabulary

LOGGER = logging.getLogger(__name__)


class DecoderData(NamedTuple):
    input_elements: List[str]
    target_data: List[str]


class TokenizedOutput(NamedTuple):
    token_ids: List[int]
    length: int
    num_input_elements: int
    # Per decoding step, indices of input elements equal to the target token.
    copyable_elements: List[np.ndarray]


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.full((), -math.inf, dtype=like.dtype, device=like.device)


class GruCopyingDecoder(torch.nn.Module):
    """The decoder's parameters sit under the JAX package's keys:
    ``embedding`` (``N(0, 1)``, tied to the output projection),
    ``gru``, ``mem_to_std`` and ``mem_to_copy`` (bias-free), and the raw
    ``hidden_to_vocab [2H, E]`` (``0.01 N(0, 1)``) and ``vocab_bias [V]``
    (zeros)."""

    def __init__(
        self,
        vocabulary_size: int,
        embedding_size: int,
        hidden_size: int,
        memories_hidden_dim: int,
        unk_id: int,
        dropout_rate: float,
    ):
        super().__init__()
        self.vocabulary_size = vocabulary_size
        self.embedding_size = embedding_size
        self.hidden_size = hidden_size
        self.unk_id = unk_id
        self.dropout_rate = dropout_rate
        self.embedding = Embedding(vocabulary_size, embedding_size, weight_init=init.normal())
        self.gru = GRU(embedding_size, hidden_size)
        self.mem_to_std = Linear(memories_hidden_dim, hidden_size, use_bias=False,
                                 weight_init=init.kaiming_uniform())
        self.mem_to_copy = Linear(memories_hidden_dim, hidden_size, use_bias=False,
                                  weight_init=init.kaiming_uniform())
        self.hidden_to_vocab = torch.nn.Parameter(torch.empty(2 * hidden_size, embedding_size))
        self.vocab_bias = torch.nn.Parameter(torch.empty(vocabulary_size))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init.normal(std=0.01)(self.hidden_to_vocab.data, generator)
        self.vocab_bias.data.zero_()

    def compute_logprobs(
        self,
        initial_states: torch.Tensor,  # [B, H]
        input_memories: torch.Tensor,  # [M, D]
        input_memories_origin_idx: torch.Tensor,  # [M] in [0, B) (padding: B)
        memory_mask: torch.Tensor,  # [M] bool
        input_token_ids: torch.Tensor,  # [B, T]
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """(copy log-probabilities [M, T], vocabulary log-probabilities
        [B, T, V], the GRU's final state [B, H])."""
        origin = input_memories_origin_idx
        num_targets = initial_states.shape[0]
        rate = self.dropout_rate
        emb = dropout(self.embedding(input_token_ids), rate, train, generator)
        output_states, final_state = self.gru(emb, initial_states)
        output_states = output_states.float()  # [B, T, H]

        std_reps = self.mem_to_std(input_memories).float()  # [M, H]
        copy_reps = dropout(self.mem_to_copy(input_memories), rate, train, generator).float()

        safe_origin = origin.clamp(max=num_targets - 1).long()
        out_per_input = take_rows(output_states, safe_origin)  # [M, T, H]
        std_scores = torch.einsum("mth,mh->mt", out_per_input, std_reps)
        copy_scores = torch.einsum("mth,mh->mt", out_per_input, copy_reps)

        std_logprobs = segment_log_softmax(std_scores, origin, num_targets, mask=memory_mask)  # [M, T]
        std_att_mul = torch.exp(std_logprobs)[..., None] * std_reps[:, None, :]
        std_att_out = segment_sum(std_att_mul, origin, num_targets, mask=memory_mask)  # [B, T, H]

        concat = torch.cat([dropout(std_att_out, rate, train, generator), output_states], dim=-1)  # [B, T, 2H]
        emb_weight = dropout(self.embedding.weight, rate, train, generator).float()
        # The JAX package's "bth,he,ve->btv", contracted in XLA's order.
        target_scores = (concat @ self.hidden_to_vocab.float()) @ emb_weight.T + self.vocab_bias.float()

        total_copy_scores = segment_logsumexp(copy_scores, origin, num_targets, mask=memory_mask)  # [B, T]
        all_scores = torch.cat([target_scores, total_copy_scores[..., None]], dim=-1)
        # A logsumexp that tolerates the -inf copy column. Its shift takes the
        # total copy score where finite: shifting by the vocabulary maximum
        # alone overflows exp() once the copy score dominates by ~88.
        neg_inf = _neg_inf(total_copy_scores)
        shift = torch.maximum(
            target_scores.amax(dim=-1),
            torch.where(torch.isfinite(total_copy_scores), total_copy_scores, neg_inf),
        )
        normalizing_const = torch.log(torch.exp(all_scores - shift[..., None]).sum(dim=-1)) + shift  # [B, T]

        target_logprobs = target_scores - normalizing_const[..., None]
        copy_logprobs = copy_scores - take_rows(normalizing_const, safe_origin)  # [M, T]
        return copy_logprobs, target_logprobs, final_state

    def forward(
        self,
        *,
        input_memories: torch.Tensor,  # [M, D]
        input_memories_origin_idx: torch.Tensor,  # [M]
        memory_mask: torch.Tensor,  # [M]
        initial_states: torch.Tensor,  # [B, H]
        target_token_ids: torch.Tensor,  # [B, S]
        target_lengths: torch.Tensor,  # [B]
        copy_matrix: torch.Tensor,  # [M, S-1] bool
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """The copy-marginalised negative log-likelihood, averaged over each
        sequence's steps and over the sequences; rows of length 0 are
        padding. Returns (loss, metric accumulators)."""
        origin = input_memories_origin_idx
        copy_logprobs, target_logprobs, _ = self.compute_logprobs(
            initial_states, input_memories, origin, memory_mask, target_token_ids[:, :-1],
            train=train, generator=generator,
        )
        num_targets, s = target_token_ids.shape
        neg_inf = _neg_inf(copy_logprobs)

        valid_copy = copy_matrix & memory_mask[:, None]  # [M, S-1]
        num_valid_copy = segment_sum(valid_copy.float(), origin, num_targets)  # [B, S-1]
        # UNK is only a correct generation where nothing can be copied.
        targets = target_token_ids[:, 1:].long()
        gen_blocked = (num_valid_copy > 0) & (targets == self.unk_id)

        correct_generation = target_logprobs.gather(-1, targets[..., None])[..., 0]  # [B, S-1]
        correct_generation = torch.where(gen_blocked, neg_inf, correct_generation)
        correct_copy = segment_logsumexp(
            torch.where(valid_copy, copy_logprobs, neg_inf), origin, num_targets, mask=memory_mask
        )  # [B, S-1]

        any_correct = torch.logaddexp(correct_generation, correct_copy)
        step_mask = torch.arange(s - 1, device=target_lengths.device)[None, :] < target_lengths[:, None]
        row_valid = target_lengths > 0
        zero = torch.zeros((), dtype=any_correct.dtype, device=any_correct.device)
        per_seq = torch.where(step_mask, any_correct, zero).sum(dim=-1) / step_mask.sum(dim=-1).clamp_min(1)
        num_rows = row_valid.sum().clamp_min(1)
        loss = -torch.where(row_valid, per_seq, zero).sum() / num_rows.float()
        return loss, {"num_sequences": row_valid.sum()}


class _CopyGroups(NamedTuple):
    """The copy groups of one decode batch, folded for ``k`` beams, on the
    memories' device (see :meth:`GruCopyingDecoderModel._build_copy_groups`):
    the decode loop's tensor inputs. Each group's string stays on the host."""

    memories: torch.Tensor  # [k*M, D]
    origin: torch.Tensor  # [k*M], beam j's sample b at j*B + b; padding k*B
    memory_mask: torch.Tensor  # [k*M]
    mem_group: torch.Tensor  # [k*M] group of each memory, beam j's at j*G + g
    mem_group_mask: torch.Tensor  # [k*M]
    flat_idx: torch.Tensor  # [k*G] (row, vocabulary id) of each in-vocabulary group; others out of range
    in_vocab: torch.Tensor  # [k*G]
    oov_live: torch.Tensor  # [B, G]: group g is an out-of-vocabulary string of sample b

    @property
    def g_pad(self) -> int:
        return self.oov_live.shape[1]


class GruCopyingDecoderModel(AbstractNeuralModel[DecoderData, TokenizedOutput, GruCopyingDecoder]):
    """Host side: the output vocabulary, tensorization of targets and
    copyable positions, static minibatches, and decoding."""

    def __init__(
        self,
        *,
        max_seq_len: int = 8,
        hidden_size: int = 128,
        embedding_size: int = 256,
        memories_hidden_dim: int = 128,
        vocabulary_max_size: int = 20000,
        vocabulary_count_threshold: int = 5,
        dropout_rate: float = 0.2,
    ):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.hidden_size = hidden_size
        self.embedding_size = embedding_size
        self.memories_hidden_dim = memories_hidden_dim
        self.vocabulary_max_size = vocabulary_max_size
        self.vocabulary_count_threshold = vocabulary_count_threshold
        self.dropout_rate = dropout_rate

    @property
    def END(self) -> str:
        return "%END%"

    @property
    def START(self) -> str:
        return "%START%"

    # ---- metadata ----
    def initialize_metadata(self) -> None:
        self.__token_counter: Counter = Counter()

    def update_metadata_from(self, datapoint: DecoderData) -> None:
        self.__token_counter.update(datapoint.target_data)

    def finalize_metadata(self) -> None:
        self.__token_counter[self.START] = 1000000
        self.__token_counter[self.END] = 1000000
        self.__output_vocabulary = Vocabulary.create_vocabulary(
            self.__token_counter,
            max_size=self.vocabulary_max_size,
            count_threshold=self.vocabulary_count_threshold,
        )
        LOGGER.info("Output vocabulary Size %s", len(self.__output_vocabulary))
        del self.__token_counter

    @property
    def vocabulary(self) -> Vocabulary:
        return self.__output_vocabulary

    def build_neural_module(self) -> GruCopyingDecoder:
        """A new (uninitialised, CPU) decoder; the root model initialises and
        places it."""
        return GruCopyingDecoder(
            vocabulary_size=len(self.__output_vocabulary),
            embedding_size=self.embedding_size,
            hidden_size=self.hidden_size,
            memories_hidden_dim=self.memories_hidden_dim,
            unk_id=self.__output_vocabulary.get_id_or_unk(Vocabulary.get_unk()),
            dropout_rate=self.dropout_rate,
        )

    # ---- tensorization ----
    def tensorize(self, datapoint: DecoderData) -> TokenizedOutput:
        target_with_start_end = [self.START] + list(datapoint.target_data) + [self.END]
        target_with_start_end = target_with_start_end[: self.max_seq_len]
        return TokenizedOutput(
            token_ids=self.__output_vocabulary.get_id_or_unk_multiple(target_with_start_end),
            length=len(target_with_start_end),
            num_input_elements=len(datapoint.input_elements),
            copyable_elements=[
                np.array([i for i, element in enumerate(datapoint.input_elements) if element == token],
                         dtype=np.int32)
                for token in target_with_start_end[1:]
            ],
        )

    # ---- minibatching ----
    def initialize_minibatch(self) -> Dict[str, Any]:
        return {
            "target_token_ids": [],
            "target_seq_lengths": [],
            "copyable_elements_idxs": [],
            "num_input_elements": [],
        }

    def extend_minibatch_with(self, tensorized_datapoint: TokenizedOutput, partial_minibatch) -> bool:
        partial_minibatch["target_token_ids"].append(tensorized_datapoint.token_ids)
        partial_minibatch["target_seq_lengths"].append(tensorized_datapoint.length)
        partial_minibatch["copyable_elements_idxs"].append(tensorized_datapoint.copyable_elements)
        partial_minibatch["num_input_elements"].append(tensorized_datapoint.num_input_elements)
        return True

    def finalize_minibatch(
        self,
        accumulated_minibatch_data: Dict[str, Any],
        max_targets: Optional[int] = None,
        memories_budget: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Targets padded to ``[max_targets, S]`` and the dense copy matrix
        ``[memories_budget, S-1]``. Each sample's memories must occupy one
        contiguous run of slots, in the order the samples were added (the
        GNN batcher lays reference sets out so)."""
        s = self.max_seq_len
        num_inputs = accumulated_minibatch_data["num_input_elements"]
        b = max_targets if max_targets is not None else len(num_inputs)
        m = memories_budget if memories_budget is not None else int(sum(num_inputs))

        target_token_ids = np.zeros((b, s), np.int32)
        target_lengths = np.zeros(b, np.int32)
        copy_matrix = np.zeros((m, s - 1), bool)
        offset = 0
        for sample_idx, (token_ids, length, copyables, count) in enumerate(zip(
            accumulated_minibatch_data["target_token_ids"],
            accumulated_minibatch_data["target_seq_lengths"],
            accumulated_minibatch_data["copyable_elements_idxs"],
            num_inputs,
        )):
            target_token_ids[sample_idx, : len(token_ids)] = token_ids
            target_lengths[sample_idx] = length
            for t, idxs in enumerate(copyables):
                if len(idxs):
                    copy_matrix[offset + idxs, t] = True
            offset += count
        return {"target_token_ids": target_token_ids, "target_lengths": target_lengths, "copy_matrix": copy_matrix}

    # ---- decoding ----
    def greedy_decode(
        self,
        *,
        input_concrete_values: List[str],
        input_memories: torch.Tensor,
        input_memories_origin_idx: torch.Tensor,
        memory_mask: torch.Tensor,
        initial_states: torch.Tensor,
        neural_module: GruCopyingDecoder,
        num_real_targets: Optional[int] = None,
        device_resident: bool = True,
        top_k: int = 100,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> List[Tuple[List[str], float]]:
        """Greedy decoding with copy mass merged by string: per sample
        (tokens, log-probability).

        ``device_resident`` (the default) keeps the whole loop on the
        memories' device, merging copy mass exactly over the full vocabulary.
        ``device_resident=False`` is the host loop that merges the top
        ``top_k`` vocabulary entries with the copy candidates, one
        device-to-host copy a step: the oracle of the device loop.
        ``temperature > 0`` samples each action by Gumbel-max from
        ``generator`` (on the memories' device); the log-probabilities
        are still those of the chosen actions."""
        if device_resident:
            return self._greedy_decode_device(
                input_concrete_values=input_concrete_values, input_memories=input_memories,
                input_memories_origin_idx=input_memories_origin_idx, memory_mask=memory_mask,
                initial_states=initial_states, neural_module=neural_module,
                num_real_targets=num_real_targets, temperature=temperature, generator=generator,
            )
        if temperature != 0.0:
            raise ValueError("sampling (temperature > 0) runs only in the device-resident loop")
        return self._greedy_decode_host(
            input_concrete_values=input_concrete_values, input_memories=input_memories,
            input_memories_origin_idx=input_memories_origin_idx, memory_mask=memory_mask,
            initial_states=initial_states, neural_module=neural_module,
            num_real_targets=num_real_targets, top_k=top_k,
        )

    def _build_copy_groups(
        self, input_concrete_values, input_memories_origin_idx, memory_mask,
        batch_size: int, b_pad: int, unk_id: int,
    ):
        """Host-side copy groups: one group per distinct (sample, concrete
        string), so copy mass merges per string (every position that holds
        the string is one candidate). Returns (group of each memory, its
        mask, each group's sample (padding ``b_pad``), its vocabulary id (-1
        out of vocabulary or padding), its validity, its string, the group
        budget ``g_pad``, the memory budget)."""
        output_vocab = self.__output_vocabulary
        mask_np = np.asarray(memory_mask)
        real_memory_slots = np.where(mask_np)[0]
        if len(real_memory_slots) != len(input_concrete_values):
            raise ValueError(f"{len(real_memory_slots)} real memories but "
                             f"{len(input_concrete_values)} concrete values")
        origin_np = np.asarray(input_memories_origin_idx)
        m_pad = origin_np.shape[0]

        group_of: Dict[Tuple[int, str], int] = {}
        group_strings: List[str] = []
        group_sample_l: List[int] = []
        group_vocab_l: List[int] = []
        mem_group = np.zeros(m_pad, np.int32)
        mem_group_mask = np.zeros(m_pad, bool)
        for slot, concrete in zip(real_memory_slots, input_concrete_values):
            bi = int(origin_np[slot])
            if bi >= batch_size:
                continue
            key = (bi, concrete)
            if key not in group_of:
                group_of[key] = len(group_strings)
                group_strings.append(concrete)
                group_sample_l.append(bi)
                vid = output_vocab.get_id_or_unk(concrete)
                # The UNK id means out of vocabulary unless the string is the
                # UNK token itself; such groups are candidates of their own.
                is_oov = vid == unk_id and concrete != Vocabulary.get_unk()
                group_vocab_l.append(-1 if is_oov else vid)
            mem_group[slot] = group_of[key]
            mem_group_mask[slot] = True
        # A power of two: the group budget sets the shape of the candidate
        # scores, and so the candidate ids above the vocabulary.
        g_pad = 1 << (max(1, len(group_strings)) - 1).bit_length()
        group_sample = np.full(g_pad, b_pad, np.int32)
        group_vocab = np.full(g_pad, -1, np.int32)
        group_sample[: len(group_sample_l)] = group_sample_l
        group_vocab[: len(group_vocab_l)] = group_vocab_l
        group_valid = np.arange(g_pad) < len(group_strings)
        return (mem_group, mem_group_mask, group_sample, group_vocab, group_valid,
                group_strings, g_pad, m_pad)

    def _copy_groups(self, k: int, input_concrete_values, input_memories, input_memories_origin_idx,
                     memory_mask, batch_size: int, b_pad: int, vocab_size: int,
                     unk_id: int) -> Tuple[_CopyGroups, List[str]]:
        """The copy groups on the memories' device, folded for ``k`` beams,
        and each group's string."""
        device = input_memories.device
        origin_np = np.asarray(input_memories_origin_idx.cpu())
        mask_np = np.asarray(memory_mask.cpu())
        mem_group, mem_group_mask, group_sample, group_vocab, group_valid, strings, g_pad, _ = (
            self._build_copy_groups(input_concrete_values, origin_np, mask_np, batch_size, b_pad, unk_id))
        beams = np.arange(k)
        origin_k = np.where(origin_np[None] < b_pad, origin_np[None] + beams[:, None] * b_pad, k * b_pad)
        in_vocab = group_valid & (group_vocab >= 0)
        flat_idx = np.where(
            in_vocab[None],
            (group_sample[None] + beams[:, None] * b_pad) * vocab_size + np.maximum(group_vocab, 0)[None],
            k * b_pad * vocab_size,
        )
        oov_live = (group_sample[None, :] == np.arange(b_pad)[:, None]) & (group_valid & (group_vocab < 0))[None]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return _CopyGroups(
            memories=input_memories.repeat(k, 1),
            origin=dev(origin_k.reshape(-1).astype(np.int64)),
            memory_mask=dev(np.tile(mask_np, k)),
            mem_group=dev((mem_group[None] + beams[:, None] * g_pad).reshape(-1).astype(np.int64)),
            mem_group_mask=dev(np.tile(mem_group_mask, k)),
            flat_idx=dev(flat_idx.reshape(-1).astype(np.int64)),
            in_vocab=dev(np.tile(in_vocab, k)),
            oov_live=dev(oov_live),
        ), strings

    @staticmethod
    def _candidate_logprobs(neural_module: GruCopyingDecoder, groups: _CopyGroups, states, tokens):
        """One step of ``k`` beams folded into rows ``[k*B]``: the merged
        candidate log-probabilities ``[k*B, V + G]`` (the vocabulary with the
        copy mass of its in-vocabulary groups, then the out-of-vocabulary
        groups) and the next GRU states."""
        rows, vocab_size, g_pad = states.shape[0], neural_module.vocabulary_size, groups.g_pad
        b_pad = groups.oov_live.shape[0]
        k = rows // b_pad
        copy_lp, target_lp, states = neural_module.compute_logprobs(
            states, groups.memories, groups.origin, groups.memory_mask, tokens)
        group_copy = segment_logsumexp(copy_lp[:, 0], groups.mem_group, k * g_pad, mask=groups.mem_group_mask)
        copy_into_vocab = segment_logsumexp(
            group_copy, groups.flat_idx, rows * vocab_size, mask=groups.in_vocab).reshape(rows, vocab_size)
        merged_vocab = torch.logaddexp(target_lp[:, 0], copy_into_vocab)
        oov_scores = torch.where(groups.oov_live[None], group_copy.reshape(k, 1, g_pad), _neg_inf(group_copy))
        return torch.cat([merged_vocab, oov_scores.reshape(rows, g_pad)], dim=1), states

    def _tokens(self, actions, vocab_size: int, strings: List[str]) -> List[str]:
        """The tokens of one sequence of emitted candidate ids, up to END or
        the first -1 (a finished sequence's placeholder)."""
        end_id = self.__output_vocabulary.get_id_or_unk(self.END)
        tokens: List[str] = []
        for wid in actions:
            wid = int(wid)
            if wid < 0 or wid == end_id:
                break
            tokens.append(self.__output_vocabulary.get_name_for_id(wid) if wid < vocab_size
                          else strings[wid - vocab_size])
        return tokens

    @torch.no_grad()
    def _greedy_decode_device(
        self,
        *,
        input_concrete_values: List[str],
        input_memories: torch.Tensor,
        input_memories_origin_idx: torch.Tensor,
        memory_mask: torch.Tensor,
        initial_states: torch.Tensor,
        neural_module: GruCopyingDecoder,
        num_real_targets: Optional[int] = None,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> List[Tuple[List[str], float]]:
        b_pad, device = initial_states.shape[0], initial_states.device
        batch_size = int(num_real_targets) if num_real_targets is not None else b_pad
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a torch.Generator")
        groups, strings = self._copy_groups(1, input_concrete_values, input_memories, input_memories_origin_idx,
                                            memory_mask, batch_size, b_pad, neural_module.vocabulary_size,
                                            neural_module.unk_id)
        # Sampling or not is part of the loop's signature; the temperature is
        # one of its tensor inputs.
        temp = torch.tensor(temperature, dtype=torch.float32, device=device) if temperature > 0.0 else None
        loop = self.decode_loop("greedy", neural_module, device, generator if temp is not None else None)
        emitted, logps = loop(groups, initial_states, temp)
        # The loop's results reach the host here, before the next call
        # replays into the same buffers.
        emitted_np, logps_np = emitted.cpu().numpy(), logps.cpu().numpy()
        return [(self._tokens(emitted_np[bi], neural_module.vocabulary_size, strings), float(logps_np[bi]))
                for bi in range(batch_size)]

    def decode_loop(self, kind: str, neural_module: GruCopyingDecoder, device: torch.device,
                    generator: Optional[torch.Generator] = None) -> CompiledStep:
        """The compiled decode loop of ``neural_module``: ``kind`` "greedy"
        (:meth:`_greedy_loop`, sampling from ``generator``, which the graphs
        register) or "beam" (:meth:`_beam_loop`). One per (kind, module,
        device, generator), kept on this model as the JAX package keeps its
        jitted decodes; each holds a graph per signature (batch, memory and
        group budgets, beams, sampling or not). Its ``fn`` runs the loop
        eagerly. The graphs read the module's parameters where they lie, so
        they see later in-place updates (training, ``load_state_dict``)."""
        cache = self.__dict__.setdefault("_decode_loops_compiled_cache", {})
        key = (kind, id(neural_module), canonical_device(device), None if generator is None else id(generator))
        entry = cache.get(key)
        if entry is None or entry[0] is not neural_module or entry[1] is not generator:
            if kind == "greedy":
                fn = functools.partial(self._greedy_loop, neural_module, generator=generator)
            elif kind == "beam":
                fn = functools.partial(self._beam_loop, neural_module)
            else:
                raise ValueError(f"unknown decode loop {kind!r}")
            generators = [] if generator is None else [generator]
            entry = cache[key] = (neural_module, generator, CompiledStep(fn, device, generators=generators))
        return entry[2]

    def _greedy_loop(self, neural_module: GruCopyingDecoder, groups: _CopyGroups, initial_states: torch.Tensor,
                     temperature: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        """The greedy loop over ``max_seq_len`` steps on the device: each
        step's action is the best merged candidate, or with ``temperature``
        (a device scalar) a Gumbel-max sample from ``generator``. Nothing in
        it waits for the device. Returns the emitted candidate ids ``[B, S]``
        (-1 after END) and each row's summed log-probability ``[B]``, on the
        device."""
        vocab_size, unk_id = neural_module.vocabulary_size, neural_module.unk_id
        end_id = self.__output_vocabulary.get_id_or_unk(self.END)
        if temperature is not None and generator is None:
            raise ValueError("sampling (a temperature) needs a torch.Generator")
        b_pad, device = initial_states.shape[0], initial_states.device
        states = initial_states
        next_tokens = torch.full((b_pad, 1), self.__output_vocabulary.get_id_or_unk(self.START),
                                 dtype=torch.int64, device=device)
        done = torch.zeros(b_pad, dtype=torch.bool, device=device)
        logps = torch.zeros(b_pad, dtype=torch.float32, device=device)
        emitted = []
        for _ in range(self.max_seq_len):
            cand, states = self._candidate_logprobs(neural_module, groups, states, next_tokens)
            choose = cand
            if temperature is not None:
                # Gumbel-max: argmax(cand + T * gumbel) samples in proportion
                # to exp(cand / T); -inf candidates stay -inf.
                u = torch.rand(cand.shape, generator=generator, device=device).clamp_min(1e-20)
                choose = cand + temperature * -torch.log(-torch.log(u))
            winner = choose.argmax(dim=1)  # the first maximum, as jnp.argmax
            winner_score = cand.gather(1, winner[:, None])[:, 0]
            is_vocab_win = winner < vocab_size
            feed = torch.where(is_vocab_win, winner, unk_id)
            chose_end = is_vocab_win & (winner == end_id)
            emitted.append(torch.where(done, -1, winner))
            logps = logps + torch.where(done, 0.0, winner_score)
            done = done | chose_end
            next_tokens = torch.where(done, end_id, feed)[:, None]
        return torch.stack(emitted, dim=1), logps

    @torch.no_grad()
    def beam_decode(
        self,
        *,
        beam_size: int,
        input_concrete_values: List[str],
        input_memories: torch.Tensor,
        input_memories_origin_idx: torch.Tensor,
        memory_mask: torch.Tensor,
        initial_states: torch.Tensor,
        neural_module: GruCopyingDecoder,
        num_real_targets: Optional[int] = None,
    ) -> List[List[Tuple[List[str], float]]]:
        """Beam search over the joint vocabulary and copy-group candidates,
        on the memories' device. Per sample the ``beam_size`` best sequences
        as (tokens, log-probability), best first.

        Each step keeps, per sample, the ``beam_size`` best of all beams'
        extensions; equal scores go to the lower (beam, candidate) index, as
        ``jax.lax.top_k`` orders them. A finished beam is frozen by an END
        self-transition of cost 0, so its score stays comparable, and only
        beam 0 is live at the first step (all beams start equal). The (action,
        parent) trace is backtracked on the host."""
        if beam_size < 1:
            raise ValueError("beam_size must be >= 1")
        b_pad = initial_states.shape[0]
        batch_size = int(num_real_targets) if num_real_targets is not None else b_pad
        vocab_size = neural_module.vocabulary_size
        groups, strings = self._copy_groups(beam_size, input_concrete_values, input_memories,
                                            input_memories_origin_idx, memory_mask, batch_size, b_pad, vocab_size,
                                            neural_module.unk_id)
        loop = self.decode_loop("beam", neural_module, initial_states.device)
        emits, parents, scores = loop(groups, initial_states, beam_size)
        # The loop's results reach the host here, before the next call
        # replays into the same buffers.
        emits_np, parents_np, scores_np = emits.cpu().numpy(), parents.cpu().numpy(), scores.cpu().numpy()
        results: List[List[Tuple[List[str], float]]] = []
        for bi in range(batch_size):
            beams = []
            for rank in range(beam_size):
                actions, idx = [], rank
                for t in range(self.max_seq_len - 1, -1, -1):
                    actions.append(int(emits_np[t, bi, idx]))
                    idx = int(parents_np[t, bi, idx])
                actions.reverse()
                beams.append((self._tokens(actions, vocab_size, strings), float(scores_np[bi, rank])))
            results.append(beams)
        return results

    def _beam_loop(self, neural_module: GruCopyingDecoder, groups: _CopyGroups, initial_states: torch.Tensor,
                   k: int):
        """The beam search's loop over ``max_seq_len`` steps on the device,
        ``k`` beams folded into the rows. Nothing in it waits for the device.
        Returns each step's emitted candidate ids and parent beams ``[S, B,
        k]`` and the final scores ``[B, k]``, best first, on the device."""
        vocab_size, unk_id = neural_module.vocabulary_size, neural_module.unk_id
        end_id = self.__output_vocabulary.get_id_or_unk(self.END)
        n_cand = vocab_size + groups.g_pad
        (b_pad, hidden), device = initial_states.shape, initial_states.device
        states = initial_states.repeat(k, 1)  # [k*B, H], beam-major
        toks = torch.full((k * b_pad, 1), self.__output_vocabulary.get_id_or_unk(self.START),
                          dtype=torch.int64, device=device)
        done = torch.zeros(k, b_pad, dtype=torch.bool, device=device)
        scores = torch.full((k, b_pad), -math.inf, dtype=torch.float32, device=device)
        scores[0] = 0.0
        emits, parents = [], []
        for _ in range(self.max_seq_len):
            cand, new_states = self._candidate_logprobs(neural_module, groups, states, toks)
            cand = cand.reshape(k, b_pad, n_cand)
            frozen = torch.full_like(cand, -math.inf)
            frozen[..., end_id] = 0.0
            cand = torch.where(done[:, :, None], frozen, cand)
            total = scores[:, :, None] + cand  # [k, B, nc]
            flat = total.permute(1, 0, 2).reshape(b_pad, k * n_cand)
            # A stable descending sort keeps equal scores in index order.
            ordered, order = torch.sort(flat, dim=1, descending=True, stable=True)
            top_scores, top_idx = ordered[:, :k], order[:, :k]  # [B, k]
            parent = top_idx // n_cand
            action = top_idx % n_cand
            by_sample = new_states.reshape(k, b_pad, hidden).permute(1, 0, 2)  # [B, k, H]
            sel_states = by_sample.gather(1, parent[:, :, None].expand(-1, -1, hidden))
            parent_done = done.T.gather(1, parent)  # [B, k]
            is_vocab = action < vocab_size
            chose_end = is_vocab & (action == end_id)
            new_done = parent_done | chose_end
            states = sel_states.permute(1, 0, 2).reshape(k * b_pad, hidden)
            toks = torch.where(new_done, end_id, torch.where(is_vocab, action, unk_id)).T.reshape(k * b_pad, 1)
            done = new_done.T
            scores = top_scores.T
            emits.append(torch.where(parent_done, -1, action))
            parents.append(parent)
        return torch.stack(emits), torch.stack(parents), scores.T

    @torch.no_grad()
    def _greedy_decode_host(
        self,
        *,
        input_concrete_values: List[str],
        input_memories: torch.Tensor,
        input_memories_origin_idx: torch.Tensor,
        memory_mask: torch.Tensor,
        initial_states: torch.Tensor,
        neural_module: GruCopyingDecoder,
        num_real_targets: Optional[int] = None,
        top_k: int = 100,
    ) -> List[Tuple[List[str], float]]:
        """The reference's loop: the device computes each step's
        log-probabilities, the host merges copy probabilities by string into
        the top ``top_k`` vocabulary entries and picks the best."""
        output_vocab = self.__output_vocabulary
        b_pad = initial_states.shape[0]
        batch_size = int(num_real_targets) if num_real_targets is not None else b_pad
        real_memory_slots = np.where(np.asarray(memory_mask.cpu()))[0]
        if len(real_memory_slots) != len(input_concrete_values):
            raise ValueError(f"{len(real_memory_slots)} real memories but "
                             f"{len(input_concrete_values)} concrete values")
        origin_np = np.asarray(input_memories_origin_idx.cpu())

        current_states = initial_states
        next_tokens = np.full((b_pad, 1), output_vocab.get_id_or_unk(self.START), np.int64)
        predicted_tokens: List[List[str]] = [[] for _ in range(batch_size)]
        predicted_logprobs = [0.0 for _ in range(batch_size)]
        sample_done = np.zeros(batch_size, bool)
        for _ in range(self.max_seq_len):
            copy_logprobs, target_logprobs, current_states = neural_module.compute_logprobs(
                current_states, input_memories, input_memories_origin_idx, memory_mask,
                torch.from_numpy(next_tokens).to(initial_states.device),
            )
            target_lp = target_logprobs[:, 0, :].cpu().numpy()  # [B, V]
            copy_lp = copy_logprobs[:, 0].cpu().numpy()  # [M]

            k = min(top_k, target_lp.shape[-1])
            topk_idxs = np.argpartition(-target_lp, k - 1, axis=-1)[:, :k]
            merged = [
                {output_vocab.get_name_for_id(int(i)): float(target_lp[bi, i]) for i in topk_idxs[bi]}
                for bi in range(batch_size)
            ]
            for slot, concrete in zip(real_memory_slots, input_concrete_values):
                bi = int(origin_np[slot])
                if bi >= batch_size:
                    continue
                merged[bi][concrete] = float(np.logaddexp(merged[bi].get(concrete, -math.inf), copy_lp[slot]))

            step_tokens = []
            for bi in range(batch_size):
                if sample_done[bi]:
                    step_tokens.append(self.END)
                    continue
                predicted_token, predicted_logprob = max(merged[bi].items(), key=lambda x: x[1])
                if predicted_token == self.END:
                    sample_done[bi] = True
                else:
                    predicted_tokens[bi].append(predicted_token)
                step_tokens.append(predicted_token)
                predicted_logprobs[bi] += predicted_logprob

            next_tokens = np.zeros((b_pad, 1), np.int64)
            for bi, tok in enumerate(step_tokens):
                next_tokens[bi, 0] = output_vocab.get_id_or_unk(tok)
        return list(zip(predicted_tokens, predicted_logprobs))
