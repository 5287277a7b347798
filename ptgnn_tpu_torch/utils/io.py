"""Dataset file IO: jsonl.gz folders, local or remote. The port's own copy
of the JAX package's ``utils/io.py`` (which imports no JAX).

Replaces the reference's dpu-utils ``RichPath`` usage (e.g.
ptgnn/implementations/typilus/train.py:9,141-145 — ``RichPath.create(path,
azure_info_path)`` gives every CLI transparent Azure-blob access).  Here any
path containing ``://`` (``az://``, ``gs://``, ``s3://``, ``memory://``, …)
is routed through fsspec; plain paths stay on the local filesystem with no
fsspec import.  Credentials come from :func:`configure_remote_io` — the
``--azure-info`` CLI flag loads a JSON file whose keys are forwarded to the
fsspec filesystem constructor (the RichPath-equivalent auth channel).

Storage options live in a module global so that forked tensorization worker
processes (the default Linux start method) inherit them.
"""
from __future__ import annotations

import gzip
import io
import json
import random
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

_storage_options: Dict[str, Any] = {}


def configure_remote_io(auth_json_path=None, **options) -> None:
    """Set fsspec storage options for all subsequent remote opens.

    ``auth_json_path`` is the ``--azure-info`` equivalent: a JSON object of
    filesystem constructor kwargs (account name/key, tokens, …).  Explicit
    kwargs override file entries.
    """
    global _storage_options
    opts: Dict[str, Any] = {}
    if auth_json_path is not None:
        with open(auth_json_path, encoding="utf-8") as fh:
            loaded = json.load(fh)
        if not isinstance(loaded, dict):
            raise ValueError(
                f"{auth_json_path}: expected a JSON object of fsspec storage "
                f"options, got {type(loaded).__name__}"
            )
        opts.update(loaded)
    opts.update(options)
    _storage_options = opts


def is_remote_path(path) -> bool:
    s = str(path)
    return "://" in s and not s.startswith("file://")


def _remote_fs(path):
    import fsspec

    return fsspec.core.url_to_fs(str(path), **_storage_options)


def open_binary(path, mode: str = "rb"):
    """Open a local or remote file in binary mode."""
    if is_remote_path(path):
        fs, fs_path = _remote_fs(path)
        return fs.open(fs_path, mode)
    return open(path, mode)


def join_path(base, name: str):
    """Join a folder (local Path or remote URL) with a file name."""
    if is_remote_path(base):
        return f"{str(base).rstrip('/')}/{name}"
    return Path(base) / name


def data_path(value: str):
    """argparse type for dataset paths: remote URLs stay strings (``Path``
    would collapse ``://``), local paths become ``Path``."""
    return value if is_remote_path(value) else Path(value)


def iter_jsonl_gz(path) -> Iterator[Any]:
    with open_binary(path) as raw, gzip.open(raw, "rt", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def iter_jsonl(path) -> Iterator[Any]:
    """Stream one jsonl file, gzipped or plain (by extension)."""
    if str(path).endswith(".gz"):
        yield from iter_jsonl_gz(path)
        return
    with open_binary(path) as raw:
        # wrap rather than slurp: multi-GB plain jsonl must stream in
        # constant memory (works for local files and fsspec file objects)
        for line in io.TextIOWrapper(raw, encoding="utf-8"):
            line = line.strip()
            if line:
                yield json.loads(line)


def _list_folder(path, pattern: str) -> List[Any]:
    """Sorted matching files in a local or remote folder."""
    if is_remote_path(path):
        fs, fs_path = _remote_fs(path)
        if not fs.isdir(fs_path):
            raise FileNotFoundError(f"dataset folder does not exist: {path}")
        protocol = str(path).split("://", 1)[0]
        return [
            f"{protocol}://{p}"
            for p in sorted(fs.glob(f"{fs_path.rstrip('/')}/{pattern}"))
        ]
    folder = Path(path)
    if not folder.is_dir():
        raise FileNotFoundError(f"dataset folder does not exist: {folder}")
    return sorted(folder.glob(pattern))


def load_from_folder(
    path, shuffle: bool, pattern: str = "*.jsonl.gz",
    rank: Optional[int] = None, world_size: Optional[int] = None,
    rng: Optional[random.Random] = None,
) -> Iterator[Any]:
    """Stream samples from every matching file in a (local or remote) folder.

    With rank/world_size, files are interleaved round-robin across ranks
    (reference: typilus/traindistributed.py:37-47). ``shuffle`` orders the
    files with ``rng`` (the ``random`` module's generator by default): the
    processes that must read one order share a seed.
    """
    all_files = _list_folder(path, pattern)
    if not all_files:
        # Fail at the source: an empty stream otherwise surfaces much later
        # as 'no minibatches' or an empty vocabulary.
        raise FileNotFoundError(f"no '{pattern}' files under {path}")
    if rank is not None and world_size is not None:
        all_files = [f for i, f in enumerate(all_files) if i % world_size == rank]
    if shuffle:
        (rng or random).shuffle(all_files)
    for file in all_files:
        yield from iter_jsonl_gz(file)


def write_jsonl_gz(path, samples) -> None:
    with open_binary(path, "wb") as raw, gzip.open(raw, "wt", encoding="utf-8") as f:
        for sample in samples:
            f.write(json.dumps(sample) + "\n")
