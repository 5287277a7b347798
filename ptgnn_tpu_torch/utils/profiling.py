"""Profiling and roofline accounting: the counterpart of the JAX package's
``utils/profiling.py``.

* :func:`profile_trace` wraps ``torch.profiler.profile`` (CPU and, where
  there is a card, CUDA activities) and writes a Chrome/Perfetto trace;
* :func:`mp_layer_roofline` estimates one message-passing layer's floating
  point operations and memory bytes over the unified layout (the JAX
  function's arithmetic), so a measured layer time can be set against the
  card's ceilings (:meth:`LayerRoofline.time_bounds_ms`);
* :class:`Throughput` accumulates graphs/nodes/edges-per-second counters.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Optional, Union

import torch

# NVIDIA's H100 SXM datasheet peaks (dense, at the 700 W power limit).
H100_SXM_HBM_BYTES_PER_S = 3.35e12
H100_SXM_BF16_FLOPS = 989e12
H100_SXM_FLOAT32_FLOPS = 67e12


@contextlib.contextmanager
def profile_trace(log_dir: Union[str, Path], *, trace_name: str = "trace.json") -> Iterator[torch.profiler.profile]:
    """Profile the block with CPU activities and, when CUDA is available, the
    card's; on exit write the Chrome/Perfetto trace ``log_dir/trace_name``
    (chrome://tracing or ui.perfetto.dev open it). Yields the profiler, so
    the block can read ``key_averages()`` after it ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities, record_shapes=False) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / trace_name))


@dataclass(frozen=True)
class LayerRoofline:
    flops: int
    hbm_bytes: int

    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1)

    def time_bounds_ms(
        self, peak_flops: float = H100_SXM_BF16_FLOPS, peak_bw: float = H100_SXM_HBM_BYTES_PER_S
    ) -> Dict[str, float]:
        """Lower bounds at the given peaks (defaults: the H100 SXM
        datasheet's bf16 tensor-core rate and HBM3 bandwidth; pass
        ``H100_SXM_FLOAT32_FLOPS`` for a float32 layer)."""
        return {
            "compute_ms": self.flops / peak_flops * 1e3,
            "memory_ms": self.hbm_bytes / peak_bw * 1e3,
        }


def mp_layer_roofline(
    edge_slots: int,
    state_dim: int,
    message_dim: int,
    num_nodes: int,
    *,
    use_target_state: bool = True,
    bytes_per_el: int = 2,
    backward: bool = True,
) -> LayerRoofline:
    """FLOP/byte estimate for one MP layer over the unified layout: the
    per-slot typed matmul of the (source, target) states and the reads and
    writes of the gather and the aggregation; the backward triples both
    (forward, input gradient, weight gradient)."""
    din = state_dim * (2 if use_target_state else 1)
    matmul_flops = 2 * edge_slots * din * message_dim
    gather_bytes = edge_slots * din * bytes_per_el
    agg_bytes = edge_slots * message_dim * bytes_per_el + num_nodes * message_dim * 4
    fwd_flops = matmul_flops
    fwd_bytes = gather_bytes + agg_bytes
    mult = 3 if backward else 1
    return LayerRoofline(flops=fwd_flops * mult, hbm_bytes=fwd_bytes * mult)


class Throughput:
    """Walltime-windowed throughput counters (graphs/nodes/edges per sec),
    matching the reference's epoch reporting."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start: Optional[float] = None
        self.totals: Dict[str, float] = {}

    def update(self, **counts: float) -> None:
        if self._start is None:
            self._start = time.time()
        for key, value in counts.items():
            self.totals[key] = self.totals.get(key, 0.0) + float(value)

    def rates(self) -> Dict[str, float]:
        if self._start is None:
            return {}
        elapsed = max(time.time() - self._start, 1e-9)
        return {f"{k}_per_sec": v / elapsed for k, v in self.totals.items()}
