"""Device milliseconds a train step spends making and applying its keyed
message-dropout masks (``ops/fused_mp.py``: the uint32 hash of each edge's
key and column in int64, the keep test and the scaled select): the sum,
over the step's pairs of marks 6 and 7 (``KEYED_BEGIN``, ``KEYED_END``), of
the time from the end of the 6 to the start of the 7, over the traced
window's readable steps (``harness/layer_marks.py``; rank 0). The edge keys,
hashed once per layer and orientation outside the pairs, are not in it."""
from gnnbench.harness import layer_marks

COMBINE = "rank0"


def read(run):
    found = layer_marks.steps(run)
    if found is None or not any(s.keyed_pairs for s in found):
        return None
    return layer_marks.mean_ms([s.keyed_ns for s in found])
