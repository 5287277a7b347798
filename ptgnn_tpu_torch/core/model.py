"""The compositional neural-model lifecycle: metadata, tensorization,
static minibatching, and construction of the paired ``torch.nn.Module``.

As in the JAX package, minibatches are statically shaped: models with fixed
budgets implement ``can_add_to_minibatch`` so a batch closes before it would
overflow its padded shape, and ``finalize_minibatch`` returns host numpy
arrays that the caller moves to a device in one call.

The host pipeline is traced (``utils/tracing.py``): every model's
``tensorize``, ``extend_minibatch_with`` and ``finalize_minibatch`` is a
span (``ptgnn.model.tensorize``, ``ptgnn.model.extend_minibatch``,
``ptgnn.model.finalize_minibatch``), counted once per root call: a
sub-model's call inside its parent's is part of the parent's.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from collections import deque
from concurrent import futures
from pathlib import Path
from typing import Any, Dict, Generic, Iterator, List, Mapping, Optional, Tuple, Type, TypeVar

import torch

from ptgnn_tpu_torch.core.checkpoint import cpu_state, read_pickle, write_pickle
from ptgnn_tpu_torch.core.iterators import BufferedIterator, ThreadedIterator, shuffled_iterator
from ptgnn_tpu_torch.utils import tracing

_EXHAUSTED = object()

TRawDatapoint = TypeVar("TRawDatapoint")
TTensorizedDatapoint = TypeVar("TTensorizedDatapoint")
TNeuralModule = TypeVar("TNeuralModule")
TModel = TypeVar("TModel", bound="AbstractNeuralModel")

__all__ = ["AbstractNeuralModel"]

# The host pipeline's methods and the span each call of them is.
_SPANNED = {
    "tensorize": "ptgnn.model.tensorize",
    "extend_minibatch_with": "ptgnn.model.extend_minibatch",
    "finalize_minibatch": "ptgnn.model.finalize_minibatch",
}


class AbstractNeuralModel(ABC, Generic[TRawDatapoint, TTensorizedDatapoint, TNeuralModule]):
    def __init__(self):
        self.__metadata_initialized = False

    def __init_subclass__(cls, **kwargs):
        """Each of :data:`_SPANNED` that a model class defines is a span."""
        super().__init_subclass__(**kwargs)
        for attr, name in _SPANNED.items():
            fn = cls.__dict__.get(attr)
            if callable(fn) and not getattr(fn, "__isabstractmethod__", False):
                setattr(cls, attr, tracing.spanned(name)(fn))

    def __getstate__(self):
        """Models pickle whole (checkpoints are (model, state dict) blobs);
        an attribute ending in ``_compiled_cache`` holds compiled steps
        (CUDA graphs), which cannot pickle, and is dropped: it is rebuilt
        at the next call, as the JAX package drops its ``_jit_cache``."""
        return {k: v for k, v in self.__dict__.items() if not k.endswith("_compiled_cache")}

    # ---- metadata ----
    def initialize_metadata(self) -> None:
        """Set up temporary metadata accumulators (children handled separately)."""

    @abstractmethod
    def update_metadata_from(self, datapoint: TRawDatapoint) -> None:
        raise NotImplementedError()

    def finalize_metadata(self) -> None:
        """Freeze metadata; drop temporary accumulators."""

    def __initialize_metadata_recursive(self) -> None:
        self.initialize_metadata()
        for value in self.__dict__.values():
            if isinstance(value, AbstractNeuralModel):
                value.__initialize_metadata_recursive()

    def __finalize_metadata_recursive(self) -> None:
        self.finalize_metadata()
        for value in self.__dict__.values():
            if isinstance(value, AbstractNeuralModel):
                value.__finalize_metadata_recursive()
        self.__metadata_initialized = True

    @property
    def metadata_initialized(self) -> bool:
        return self.__metadata_initialized

    def compute_metadata(
        self, dataset_iterator: Iterator[TRawDatapoint], parallelize: bool = True
    ) -> None:
        """Full metadata pass over the training data (root model only)."""
        if self.__metadata_initialized:
            raise RuntimeError("Metadata has already been initialized.")
        self.__initialize_metadata_recursive()
        for element in ThreadedIterator(dataset_iterator, enabled=parallelize):
            self.update_metadata_from(element)
        self.__finalize_metadata_recursive()

    @abstractmethod
    def build_neural_module(self) -> TNeuralModule:
        raise NotImplementedError()

    # ---- saving / loading ----
    def save(self, path: Path, module: torch.nn.Module) -> None:
        """Write ``(self, module.state_dict())`` as a gzip pickle (CPU
        tensors), through a temporary file and a rename."""
        write_pickle(Path(path), (self, cpu_state(module.state_dict())))

    @classmethod
    def restore_model(cls: Type[TModel], path: Path) -> Tuple[TModel, Mapping[str, torch.Tensor]]:
        """``(model, state_dict)`` from :meth:`save`. Unpickling runs code:
        restore only files you wrote or trust."""
        model, state = read_pickle(Path(path))
        return model, state

    # ---- tensorization ----
    @abstractmethod
    def tensorize(self, datapoint: TRawDatapoint) -> Optional[TTensorizedDatapoint]:
        """Convert one raw example; return None to discard it."""
        raise NotImplementedError()

    def _tensorized_stream(self, dataset_iterator: Iterator[TRawDatapoint], return_input_data: bool):
        for datapoint in dataset_iterator:
            yield self.tensorize(datapoint), (datapoint if return_input_data else None)

    def tensorize_dataset(
        self,
        dataset_iterator: Iterator[TRawDatapoint],
        *,
        parallelize: bool = True,
        use_multiprocessing: bool = True,
        return_input_data: bool = False,
    ) -> Iterator[Tuple[TTensorizedDatapoint, Optional[TRawDatapoint]]]:
        """Stream (tensorized, raw-or-None) pairs, skipping discarded samples,
        in the input's order. With ``parallelize`` and ``use_multiprocessing``
        (the default) a forked child process tensorizes (a
        :class:`BufferedIterator`): ``tensorize`` must then be numpy-only (no
        CUDA: the parent may hold a CUDA context) and the tensorized samples
        must pickle. With ``parallelize`` alone a thread pool tensorizes,
        with a bounded window; without it, this thread. An abandoned stream
        terminates and joins its child."""
        if not self.__metadata_initialized:
            raise RuntimeError("Metadata has not been initialized.")
        if parallelize and use_multiprocessing:
            stream = BufferedIterator(self._tensorized_stream(dataset_iterator, return_input_data),
                                      max_queue_size=500)
            try:
                for sample in stream:
                    if sample[0] is not None:
                        yield sample
            finally:
                stream.close()
            return
        if not parallelize:
            for sample in self._tensorized_stream(dataset_iterator, return_input_data):
                if sample[0] is not None:
                    yield sample
            return

        def one(dp):
            return self.tensorize(dp), (dp if return_input_data else None)

        window = 64
        with futures.ThreadPoolExecutor() as pool:
            pending: "deque[futures.Future]" = deque()
            for d in dataset_iterator:
                pending.append(pool.submit(one, d))
                if len(pending) >= window:
                    sample = pending.popleft().result()
                    if sample[0] is not None:
                        yield sample
            while pending:
                sample = pending.popleft().result()
                if sample[0] is not None:
                    yield sample

    # ---- minibatching ----
    @abstractmethod
    def initialize_minibatch(self) -> Dict[str, Any]:
        raise NotImplementedError()

    def can_add_to_minibatch(
        self, tensorized_datapoint: TTensorizedDatapoint, partial_minibatch: Dict[str, Any]
    ) -> bool:
        """Static-budget admission check, called BEFORE extend_minibatch_with."""
        del tensorized_datapoint, partial_minibatch
        return True

    @abstractmethod
    def extend_minibatch_with(
        self, tensorized_datapoint: TTensorizedDatapoint, partial_minibatch: Dict[str, Any]
    ) -> bool:
        """Add a datapoint; return True if the minibatch can take more."""
        raise NotImplementedError()

    @abstractmethod
    def finalize_minibatch(self, accumulated_minibatch_data: Dict[str, Any]) -> Dict[str, Any]:
        """Produce the statically shaped numpy arrays of one minibatch."""
        raise NotImplementedError()

    def __iterate_unfinalized_minibatches(
        self,
        tensorized_data: Iterator[Tuple[TTensorizedDatapoint, Optional[TRawDatapoint]]],
        max_minibatch_size: int,
        yield_partial_minibatches: bool = True,
    ) -> Iterator[Tuple[Dict[str, Any], List[Optional[TRawDatapoint]]]]:
        tensorized_data = iter(tensorized_data)
        carried = None
        exhausted = False
        while not exhausted:
            mb_data = self.initialize_minibatch()
            mb_input_data: List[Optional[TRawDatapoint]] = []
            stopped_by_budget = False
            while len(mb_input_data) < max_minibatch_size:
                if carried is not None:
                    sample, carried = carried, None
                else:
                    sample = next(tensorized_data, _EXHAUSTED)
                    if sample is _EXHAUSTED:
                        exhausted = True
                        break
                tensorized_sample, input_data = sample
                if not self.can_add_to_minibatch(tensorized_sample, mb_data):
                    if len(mb_input_data) == 0:
                        continue  # does not fit even an empty batch: drop it
                    carried = sample
                    stopped_by_budget = True
                    break
                continue_extending = self.extend_minibatch_with(tensorized_sample, mb_data)
                mb_input_data.append(input_data)
                if not continue_extending:
                    stopped_by_budget = True
                    break
            if len(mb_input_data) == 0:
                return
            if exhausted and not stopped_by_budget and not yield_partial_minibatches:
                if len(mb_input_data) < max_minibatch_size:
                    return
            yield mb_data, mb_input_data

    def minibatch_iterator(
        self,
        tensorized_data: Iterator[Tuple[TTensorizedDatapoint, Optional[TRawDatapoint]]],
        max_minibatch_size: int,
        yield_partial_minibatches: bool = True,
        shuffle_input: bool = False,
        parallelize: bool = True,
        shuffle_rng=None,
    ) -> Iterator[Tuple[Dict[str, Any], List[Optional[TRawDatapoint]]]]:
        """Yield (finalized minibatch, raw inputs) pairs; assembly and
        finalization run pipelined in worker threads when ``parallelize``."""
        if not self.__metadata_initialized:
            raise RuntimeError("Metadata has not been initialized.")
        if shuffle_input:
            tensorized_data = shuffled_iterator(tensorized_data, buffer_size=500, rng=shuffle_rng)

        unfinalized = ThreadedIterator(
            self.__iterate_unfinalized_minibatches(
                tensorized_data, max_minibatch_size, yield_partial_minibatches
            ),
            enabled=parallelize,
        )
        finalized = ThreadedIterator(
            ((self.finalize_minibatch(d[0]), d[1]) for d in unfinalized),
            enabled=parallelize,
        )
        try:
            yield from finalized
        finally:
            finalized.close()
            unfinalized.close()
