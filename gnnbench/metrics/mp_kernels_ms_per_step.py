"""Device milliseconds a step of the port's segment kernels: K1
(``csrc/segment_sum.cu``), K2 (``csrc/segment_extremum.cu``) and K3
(``csrc/broadcast_rows.cu``), by kernel name (rank 0). Where the trace
holds fewer of them than the program's launch counters say ran, it lost
events: up to ``trace.LOST_EVENTS`` of them, the time is scaled by
launched over held (a lost launch taken at the held ones' mean); beyond
that, nothing is read."""
from gnnbench.harness import trace

KERNELS = {"segment_sum": "segment_sum_kernel", "segment_extremum": "segment_extremum_kernel",
           "broadcast_to_edges": "broadcast_rows_kernel"}
COMBINE = "rank0"


def read(run):
    seconds, count = run.trace.kernel_seconds(*KERNELS.values())
    launched = sum(run.counters.get("launches", {}).get(k, 0) for k in KERNELS)
    if not count or not run.steps or count < (1.0 - trace.LOST_EVENTS) * launched:
        return None
    return 1e3 * seconds * max(launched, count) / count / run.steps
