"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): HBM bandwidth and the arithmetic rate of each
precision a configuration may state."""
from __future__ import annotations

from typing import Any, Dict

HBM_BYTES_PER_S = 3.35e12

FLOPS_PER_S = {
    "float32": 67e12,  # outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8": 1979e12,
}

ITEMSIZE = {"float32": 4, "tf32": 4, "bfloat16": 2, "float16": 2, "fp8": 1}


def flops_per_s(config: Dict[str, Any]) -> float:
    """The peak of the configuration's compute precision."""
    return FLOPS_PER_S[config["precision"]["dtype"]]


def itemsize(config: Dict[str, Any]) -> int:
    return ITEMSIZE[config["precision"]["dtype"]]


def least_seconds(bytes_moved: float, operations: float, config: Dict[str, Any]) -> float:
    """The least time the card needs: bytes over the HBM bandwidth or
    operations over the arithmetic peak, whichever is larger."""
    return max(bytes_moved / HBM_BYTES_PER_S, operations / flops_per_s(config))
