"""Checkpoint files of the port: gzip pickles written to a temporary file and
renamed, so a crash mid-write never destroys the last good file.

A model checkpoint holds ``(model, state_dict)``: the picklable model object
(metadata, vocabularies) and its module's weights as CPU tensors. The
optimizer's state and the next epoch go to a sibling ``.optimizerstate``
file. Loading a JAX checkpoint is not supported: ``convert.py`` carries JAX
weights across instead.

Pickle runs code on load: restore only files you wrote or trust.
"""
from __future__ import annotations

import gzip
import os
import pickle
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import torch


def cpu_state(state: Any) -> Any:
    """Tensors of a (nested) state moved to the CPU, detached."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, Mapping):
        return {k: cpu_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(cpu_state(v) for v in state)
    return state


def write_pickle(path: Path, obj: Any) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with gzip.open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def read_pickle(path: Path) -> Any:
    with gzip.open(Path(path), "rb") as f:
        return pickle.load(f)


def optimizer_state_path(checkpoint: Path) -> Path:
    return Path(checkpoint).with_suffix(".optimizerstate")


def save_optimizer_state(path: Path, optimizer_state: Dict[str, Any], epoch: int) -> None:
    write_pickle(path, {"optimizer_state": cpu_state(optimizer_state), "epoch": epoch})


def load_optimizer_state(path: Path) -> Tuple[Dict[str, Any], int]:
    blob = read_pickle(path)
    return blob["optimizer_state"], blob["epoch"]
