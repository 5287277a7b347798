"""The host layout assembler in C++, loaded with ``ctypes``: the counterpart
of the JAX package's ``native/``.

``batch_assembler.cc`` is the inner loop of ``graph/batching.py``'s layout
assembly: the numpy assembler's output, bit for bit, in a fraction of its
time, and a ctypes call releases the interpreter lock, so the minibatch
iterator's worker threads assemble in parallel. The numpy assembler stays
as the oracle (``graph/batching.assemble_layout_arrays(...,
native_assembler=False)``).

The library is built at first use with the host's ``g++`` into
``build/native/`` beside the package; its file name carries a hash of the
source, the flags and ``g++ --version``, so a changed source or compiler
rebuilds and an unchanged one is reused. The flags name no host CPU
(no ``-march=native``): a checkout shared by two hosts never loads the other
host's instructions. The build holds a file lock, since data-loading
workers and data-parallel ranks start together. A failed build raises with
the compiler's output; nothing falls back to numpy quietly.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "batch_assembler.cc"
BUILD_DIR = SOURCE.parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_COMPILER: Optional[Tuple[str, bytes]] = None  # (path, its --version output)


def _compiler() -> Tuple[str, bytes]:
    global _COMPILER
    if _COMPILER is None:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native layout assembler cannot be built on this machine")
        version = subprocess.run([cxx, "--version"], capture_output=True, check=True, timeout=60).stdout
        _COMPILER = (cxx, version)
    return _COMPILER


def library_path() -> Path:
    """Where the library for this source, these flags and this compiler
    lives (built or not)."""
    _, version = _compiler()
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + version).hexdigest()
    return BUILD_DIR / f"batch_assembler-{digest[:16]}.so"


def build() -> float:
    """Build the library if it is missing, under an exclusive file lock.
    Returns the seconds this call spent compiling (0 when it was built
    already); raises with the compiler's output if the build fails."""
    cxx, _ = _compiler()
    path = library_path()
    if path.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():  # another process built it while this one waited
                return 0.0
            t0 = time.perf_counter()
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build the native layout assembler (exit {proc.returncode}):\n"
                                   f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, path)  # readers see the whole library or none
            return time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                build()
                lib = ctypes.CDLL(str(library_path()))
                i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
                u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
                fn = lib.ptgnn_assemble_edge_layout
                fn.restype = ctypes.c_int
                fn.argtypes = [
                    i32p, i32p, i32p, i32p,
                    ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32,
                    i32p, i32p, i32p, i32p, u8p, i32p, i32p, i32p, i32p,
                ]
                _LIB = lib
    return _LIB


def check_edge_ids(
    senders: np.ndarray, receivers: np.ndarray, types: np.ndarray, pair_ids: Optional[np.ndarray], *,
    max_nodes: int, num_types: int, sender_domain: Optional[int] = None,
) -> None:
    """Raise ``ValueError`` unless the arrays have one length, receivers lie
    in [0, max_nodes), senders in [0, sender_domain) (default max_nodes)
    and types in [0, num_types). The C++ loop indexes by these ids and
    checks nothing: an id out of range would write past its buffers."""
    n = len(senders)
    if len(receivers) != n or len(types) != n or (pair_ids is not None and len(pair_ids) != n):
        raise ValueError(f"edge arrays of different lengths: {n}, {len(receivers)}, {len(types)}"
                         + ("" if pair_ids is None else f", {len(pair_ids)}"))
    if not n:
        return
    domain = max_nodes if sender_domain is None else sender_domain
    for name, ids, hi in (("sender", senders, domain), ("receiver", receivers, max_nodes),
                          ("edge type", types, num_types)):
        if int(ids.min()) < 0 or int(ids.max()) >= hi:
            raise ValueError(f"{name} ids must lie in [0, {hi})")


def assemble_edge_layout(
    senders: np.ndarray, receivers: np.ndarray, types: np.ndarray, pair_ids: Optional[np.ndarray] = None, *,
    max_nodes: int, e_pad: int, tile: int, agg_rows: int, num_types: int, align: int = 0,
    sender_domain: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, ...]]:
    """The unified layout of the raw edges through the C++ assembler:
    (senders, receivers, edge_types, local_rows, edge_mask, tile_types,
    tile_row_blocks, counts [num_blocks, agg_rows], pair ids), or None if
    the edges exceed the ``e_pad`` budget. ``sender_domain`` bounds the
    sender ids, which are copied through (node-sharded boundary layouts
    index a receive buffer)."""
    if tile <= 0 or agg_rows <= 0 or e_pad % tile:
        raise ValueError(f"e_pad ({e_pad}) must be a multiple of a positive tile ({tile}); agg_rows {agg_rows}")
    check_edge_ids(senders, receivers, types, pair_ids, max_nodes=max_nodes, num_types=num_types,
                   sender_domain=sender_domain)
    fn = load().ptgnn_assemble_edge_layout
    num_blocks = -(-max_nodes // agg_rows)
    n = len(senders)
    out = {
        "senders": np.empty(e_pad, np.int32), "receivers": np.empty(e_pad, np.int32),
        "types": np.empty(e_pad, np.int32), "local_rows": np.empty(e_pad, np.int32),
        "mask": np.empty(e_pad, np.uint8), "tile_types": np.empty(e_pad // tile, np.int32),
        "tile_row_blocks": np.empty(e_pad // tile, np.int32), "counts": np.empty(num_blocks * agg_rows, np.int32),
        "pair_ids": np.empty(e_pad, np.int32),
    }
    pairs = np.full(n, -1, np.int32) if pair_ids is None else pair_ids
    rc = fn(
        np.ascontiguousarray(senders, np.int32), np.ascontiguousarray(receivers, np.int32),
        np.ascontiguousarray(types, np.int32), np.ascontiguousarray(pairs, np.int32),
        n, max_nodes, e_pad, tile, agg_rows, num_types, align, *out.values(),
    )
    if rc != 0:
        return None
    return (out["senders"], out["receivers"], out["types"], out["local_rows"], out["mask"].view(bool),
            out["tile_types"], out["tile_row_blocks"], out["counts"].reshape(num_blocks, agg_rows),
            out["pair_ids"])
