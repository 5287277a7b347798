"""Build and load the port's CUDA kernels (``ptgnn_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``. Builds happen
at first use, all sources at once (one ``nvcc`` process each, started
together), into ``_build/kernels/`` inside the package (beside its
sources, as the JAX package builds beside ``ptgnn_tpu/native/``, so two
installs never share a build); a library's file name
carries a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so a changed source or header rebuilds and an unchanged one is
reused. Nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

from ptgnn_tpu_torch.utils import tracing

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (source, function, argtypes)
    "broadcast": (
        "broadcast_rows.cu",
        "ptgnn_broadcast_rows",
        [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, _P],
    ),
    "extremum": (
        "segment_extremum.cu",
        "ptgnn_segment_extremum",
        [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, _P],
    ),
    "extremum_argmax": (
        "segment_extremum_argmax.cu",
        "ptgnn_segment_extremum_argmax",
        [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, _P],
    ),
    "sum": (
        "segment_sum.cu",
        "ptgnn_segment_sum",
        [_P, ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P],
    ),
    "typed_matmul": (
        "typed_matmul.cu",
        "ptgnn_typed_matmul",
        [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P],
    ),
    "typed_dw": (
        "typed_dw.cu",
        "ptgnn_typed_dw",
        [_P, ctypes.c_longlong, _P, ctypes.c_longlong, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P],
    ),
    "trace_mark": ("trace_mark.cu", "ptgnn_trace_mark", [ctypes.c_int, _P]),
}
# A library's other C entry points: name -> {function: argtypes}; each
# returns an int error code, as the kernels' do.
_HELPERS = {
    "trace_mark": {"ptgnn_trace_mark_nodes": [_P, _P, ctypes.c_int, _P],
                   "ptgnn_trace_mark_set_enabled": [_P, _P, ctypes.c_int, ctypes.c_int]},
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # name -> nvcc's output of this process's builds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _library_path(name: str) -> Path:
    source = CSRC_DIR / _SIGNATURES[name][0]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> float:
    """Build every kernel library that is missing, in parallel. Returns the
    seconds spent; raises with nvcc's output if a build fails."""
    with _LOCK:
        todo = {n: _library_path(n) for n in _SIGNATURES if not _library_path(n).exists()}
        if not todo:
            return 0.0
        with tracing.span("ptgnn.kernels.build") as timed:
            _build(todo)
        return timed.seconds


def _build(todo: Dict[str, Path]) -> None:
    """Run nvcc on every (name, library path) of ``todo`` at once."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / _SIGNATURES[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        output, _ = proc.communicate()
        BUILD_LOG[name] = output
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))


def kernel_function(name: str):
    """The C entry point of kernel library ``name``, built if needed."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        build_all()
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_library_path(name)))
                fn = getattr(lib, _SIGNATURES[name][1])
                fn.argtypes = _SIGNATURES[name][2]
                fn.restype = ctypes.c_int
                lib.ptgnn_error_string.argtypes = [ctypes.c_int]
                lib.ptgnn_error_string.restype = ctypes.c_char_p
                for helper, argtypes in _HELPERS.get(name, {}).items():
                    getattr(lib, helper).argtypes = argtypes
                    getattr(lib, helper).restype = ctypes.c_int
                _LIBS[name] = lib
    return getattr(lib, _SIGNATURES[name][1])


def helper_function(name: str, function: str):
    """The C entry point ``function`` of kernel library ``name`` (one of
    its ``_HELPERS``), built if needed."""
    kernel_function(name)
    return getattr(_LIBS[name], function)


def check(name: str, err: int) -> None:
    """Raise if a kernel's C function reported a CUDA error, in the form of
    PyTorch's own (``CUDA error: out of memory`` for a failed allocation,
    which ``utils/oom.is_oom_error`` recognises)."""
    if err != 0:
        message = _LIBS[name].ptgnn_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: CUDA error: {message} (error {err})")
