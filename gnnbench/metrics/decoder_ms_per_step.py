"""Device milliseconds a Graph2Seq train step spends in its decoder: mark 4
(``ENCODED``) to phase mark 1 (the backward's start: the summariser, the
GRU copy decoder and the loss), plus mark 1 to mark 5 (``DECODER_GRAD``:
their backward, up to the gradient of the encoder's node states), over the
traced window's readable steps (``harness/layer_marks.py``; rank 0)."""
from gnnbench.harness import layer_marks

COMBINE = "rank0"


def read(run):
    found = layer_marks.steps(run)
    if found is None:
        return None
    return layer_marks.mean_ms([(s.at[1] - s.at[4]) + (s.at[5] - s.at[1]) for s in found])
