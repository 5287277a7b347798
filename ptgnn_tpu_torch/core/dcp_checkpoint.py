"""Async, sharded checkpoints on ``torch.distributed.checkpoint`` (DCP): the
counterpart of the JAX package's ``core/orbax_checkpoint.py``
(``OrbaxCheckpointer``).

The default checkpoint (``core/checkpoint.py``: a gzip pickle of the model
object and its state) is synchronous, and under ZeRO-1 the trainer first
gathers the optimizer state on rank 0. :class:`DistributedCheckpointer`
adds the production alternative:

* **async saves**: ``dcp.async_save`` copies the state to host memory and
  returns; the writes overlap the next steps (:meth:`DistributedCheckpointer.wait`
  blocks until they are committed);
* **sharded writes**: each rank writes its own files. Replicated tensors
  (the parameters) are written once over all ranks; under ZeRO-1
  (``ZeroRedundancyOptimizer``) each rank writes only its own partition of
  the optimizer state, with no gather;
* **restore on another world size**: the state is keyed by parameter name,
  so each rank reads what its own partition needs, whatever the world size
  of the save;
* **retention**: the newest ``max_to_keep`` steps are kept.

The small host-side model object (metadata, vocabularies) travels as a
pickled sidecar ``{step}.model.pkl.gz`` beside the step directory, written
by rank 0, so a checkpoint stays self-describing. Paths are local: a path
with ``://`` raises. With no process group initialised it works in one
process; with one, every rank creates the checkpointer and takes part in
each save and restore, and DCP coordinates them over a gloo group of its
own (async saves need a CPU backend beside NCCL).
"""
from __future__ import annotations

import pickle
import shutil
from concurrent.futures import Future
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ptgnn_tpu_torch.core.checkpoint import read_pickle, write_pickle

__all__ = ["DistributedCheckpointer"]

_MODEL_SIDECAR = "model.pkl.gz"
_MODEL = "model."
_OPT_STATE = "optim.state."
_OPT_GROUPS = "optim.param_groups"
_STEP = "step"


def _local_optimizer(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """The optimizer whose ``state`` this rank holds: ZeRO-1's local one
    over this rank's partition, or the optimizer itself."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return optimizer.optim if isinstance(optimizer, ZeroRedundancyOptimizer) else optimizer


def _bytes_tensor(obj: Any) -> torch.Tensor:
    return torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)


class DistributedCheckpointer:
    """Async, sharded (module, optimizer, step) checkpoints under
    ``directory``, one numbered subdirectory per saved step.

    ``max_to_keep``: the newest steps to keep (None keeps all)."""

    def __init__(self, directory: Union[str, Path], *, max_to_keep: Optional[int] = 3):
        if "://" in str(directory):
            raise ValueError(f"{directory}: DistributedCheckpointer writes to local paths only")
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1 or None")
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._distributed = dist.is_available() and dist.is_initialized()
        self._rank = dist.get_rank() if self._distributed else 0
        self._group = dist.new_group(backend="gloo") if self._distributed else None
        self._pending: Optional[Future] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self._dir / str(step)

    def _sidecar(self, step: int) -> Path:
        return self._dir / f"{step}.{_MODEL_SIDECAR}"

    def all_steps(self) -> List[int]:
        """The committed steps, oldest first (a step directory is committed
        once DCP has written its ``.metadata``)."""
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit() and (p / ".metadata").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, module: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None, *,
             model: Any = None, wait: bool = False) -> None:
        """Snapshot ``step``'s parameters and buffers (and the optimizer's
        state and hyperparameters) and write them asynchronously: the call
        returns once the state is copied to host memory, so the caller may
        step on. ``model`` is the host-side model object, pickled by rank 0
        into the sidecar. A save waits for the previous one first."""
        self.wait()
        names = {id(p): name for name, p in module.named_parameters()}
        state: Dict[str, torch.Tensor] = {_MODEL + k: v for k, v in module.state_dict().items()}
        state[_STEP] = torch.tensor(step, dtype=torch.int64)
        if optimizer is not None:
            state[_OPT_GROUPS] = _bytes_tensor([{k: v for k, v in g.items() if k != "params"}
                                                for g in optimizer.param_groups])
            for param, values in _local_optimizer(optimizer).state.items():
                for key, value in values.items():
                    if not isinstance(value, torch.Tensor):
                        raise TypeError(f"optimizer state {key!r} is a {type(value).__name__}, not a tensor")
                    state[f"{_OPT_STATE}{names[id(param)]}.{key}"] = value
        self._pending = self._async_save(state, self._step_dir(step))
        if model is not None and self._rank == 0:
            write_pickle(self._sidecar(step), model)
        if wait:
            self.wait()

    def _async_save(self, state: Dict[str, torch.Tensor], path: Path) -> Future:
        response = dcp.async_save(state, checkpoint_id=str(path), process_group=self._group)
        # Newer releases return the staging and upload futures together.
        return getattr(response, "upload_completion", response)

    def wait(self) -> None:
        """Block until the save in flight has committed, then apply the
        retention."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
            if self._rank == 0:
                self._evict()

    def _evict(self) -> None:
        """Delete the steps beyond ``max_to_keep`` and every sidecar whose
        step is gone."""
        steps = self.all_steps()
        if self._max_to_keep is not None:
            for old in steps[:-self._max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
            steps = steps[-self._max_to_keep:]
        suffix = f".{_MODEL_SIDECAR}"
        for sidecar in self._dir.glob(f"*{suffix}"):
            stem = sidecar.name[: -len(suffix)]
            if stem.isdigit() and int(stem) not in steps:
                sidecar.unlink(missing_ok=True)

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None, *, module: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None) -> int:
        """Load ``step`` (the latest when None) into ``module`` and, if
        given, ``optimizer`` (this rank's partition under ZeRO-1, at any
        world size). Returns the step."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        path = self._step_dir(step)
        saved = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
        state: Dict[str, torch.Tensor] = {_MODEL + k: v for k, v in module.state_dict().items()}
        state[_STEP] = torch.zeros((), dtype=torch.int64)
        local_state = {}
        if optimizer is not None:
            if _OPT_GROUPS not in saved:
                raise KeyError(f"step {step} holds no optimizer state")

            def placeholder(key):
                meta = saved[key]
                return torch.empty(tuple(meta.size), dtype=meta.properties.dtype)

            state[_OPT_GROUPS] = placeholder(_OPT_GROUPS)
            local = _local_optimizer(optimizer)
            names = {id(p): name for name, p in module.named_parameters()}
            for group in local.param_groups:
                for param in group["params"]:
                    prefix = f"{_OPT_STATE}{names[id(param)]}."
                    keys = [k for k in saved if k.startswith(prefix) and "." not in k[len(prefix):]]
                    local_state[id(param)] = {k[len(prefix):]: placeholder(k) for k in keys}
                    state.update({k: local_state[id(param)][k[len(prefix):]] for k in keys})
        dcp.load(state, checkpoint_id=str(path), process_group=self._group)
        if optimizer is not None:
            self._load_optimizer(optimizer, pickle.loads(state[_OPT_GROUPS].numpy().tobytes()), local_state)
        return int(state[_STEP])

    @staticmethod
    def _load_optimizer(optimizer: torch.optim.Optimizer, hyperparameters: List[Dict[str, Any]],
                        local_state: Dict[int, Dict[str, torch.Tensor]]) -> None:
        """Hand the loaded state to the local optimizer in its own format,
        so that it casts and places each tensor as it does on any
        ``load_state_dict``; the hyperparameters go to every group."""
        local = _local_optimizer(optimizer)
        if len(hyperparameters) != len(local.param_groups):
            raise ValueError(f"the checkpoint has {len(hyperparameters)} parameter groups, the optimizer "
                             f"{len(local.param_groups)}")
        torch_state: Dict[str, Any] = {"state": {}, "param_groups": []}
        index = 0
        for group, saved in zip(local.param_groups, hyperparameters):
            ids = []
            for param in group["params"]:
                if local_state[id(param)]:
                    torch_state["state"][index] = local_state[id(param)]
                ids.append(index)
                index += 1
            torch_state["param_groups"].append({**saved, "params": ids})
        local.load_state_dict(torch_state)
        if local is not optimizer:  # ZeRO-1's global groups hold the hyperparameters it syncs from
            for group, saved in zip(optimizer.param_groups, hyperparameters):
                group.update(saved)

    def restore_model(self, step: Optional[int] = None) -> Any:
        """The host-side model object saved beside ``step`` (the latest when
        None)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        return read_pickle(self._sidecar(step))

    def close(self) -> None:
        """Wait for the save in flight and release the coordination group."""
        self.wait()
        if self._group is not None:
            dist.destroy_process_group(self._group)
            self._group = None
