"""The traced run: ``torch.profiler`` (CUPTI) over the measured window, and
what the per-layer readers take from it.

The window is marked by a host annotation (``WINDOW``), so the device's
operations and the window share the profiler's clock. Busy time is the
union of the device's kernel, copy and set intervals inside the window;
idle gaps are what is left, each named by the innermost host operation
running at its middle.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "gnnbench.window"
# The share of a kernel's launches that a reader lets the trace lose
# (CUPTI drops events under load): on one H100, a G2C window of about
# 440,000 device operations lost 5 of 17,395 segment-kernel launches, and a
# PPI window 10 of 2,550 typed products.
LOST_EVENTS = 0.01

Interval = Tuple[str, int, int]  # (name, start ns, end ns)

# The program's launch counters that a traced window records
# (``harness.report.LayerRun.counters["launches"]``): a reader compares
# them with the kernels the trace holds, and reads nothing from a trace
# that lost some.


@dataclass
class Trace:
    device_ops: List[Interval]  # inside the window, clipped to it
    host_ops: List[Interval]
    window: Tuple[int, int]
    busy_ns: int = 0
    gaps: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns * 1e-9

    def kernel_seconds(self, *needles: str) -> Tuple[float, int]:
        """(seconds, count) of the device operations whose name holds one
        of ``needles``."""
        total, count = 0, 0
        for name, a, b in self.device_ops:
            if any(n in name for n in needles):
                total += b - a
                count += 1
        return total * 1e-9, count

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, int] = {}
        for name, a, b in self.device_ops:
            by_name[name] = by_name.get(name, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[name[:160], ns * 1e-9] for name, ns in ops],
            "idle_gaps": [[self._host_at((a + b) // 2), (b - a) * 1e-9] for a, b in gaps],
        }

    def _host_at(self, t: int) -> str:
        best: Optional[Interval] = None
        for op in self.host_ops:
            if op[1] <= t <= op[2] and (best is None or op[2] - op[1] < best[2] - best[1]):
                best = op
        return "host: " + (best[0][:120] if best else "no host operation")


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def annotate():
    import torch

    return torch.profiler.record_function(WINDOW)


DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _events(prof):
    """(name, is a device operation, start ns, end ns) of every profiled
    event but the device-side spans of host annotations, which cover
    kernels rather than run any."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if hasattr(e, "activity_type"):
            kind = str(e.activity_type())
            if kind == "gpu_user_annotation":
                continue
            on_device = kind in DEVICE_KINDS
        elif on_device and (e.name() == WINDOW or (hasattr(e, "is_user_annotation") and e.is_user_annotation())):
            continue
        if hasattr(e, "start_ns"):
            a, d = e.start_ns(), e.duration_ns()
        else:
            a, d = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), on_device, int(a), int(a + d)))
    return out


def stop(prof) -> Trace:
    prof.__exit__(None, None, None)
    return summarize(_events(prof))


def summarize(events) -> Trace:
    """The window's Trace from (name, is device, start ns, end ns) events."""
    marks = [(a, b) for name, dev, a, b in events if name == WINDOW and not dev]
    if not marks:
        raise RuntimeError("the profiler's trace holds no window annotation")
    w0, w1 = marks[0]
    device = sorted((name, max(a, w0), min(b, w1)) for name, dev, a, b in events
                    if dev and b > w0 and a < w1 and b > a)
    device.sort(key=lambda x: x[1])
    host = [(name, a, b) for name, dev, a, b in events if not dev and name != WINDOW and b > w0 and a < w1]
    busy, gaps, cursor = 0, [], w0
    for _, a, b in device:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        gaps.append((cursor, w1))
    return Trace(device, host, (w0, w1), busy, gaps)
