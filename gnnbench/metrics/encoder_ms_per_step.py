"""Device milliseconds a Graph2Seq train step spends in its encoder: phase
mark 0 (the forward's start) to mark 4 (``ENCODED``: the embedder and the
gated stack), plus mark 5 (``DECODER_GRAD``: the gradient of the encoder's
node states is complete) to mark 2 (the optimizer's start: the stack's and
the embedder's backward), over the traced window's readable steps
(``harness/layer_marks.py``; rank 0)."""
from gnnbench.harness import layer_marks

COMBINE = "rank0"


def read(run):
    found = layer_marks.steps(run)
    if found is None:
        return None
    return layer_marks.mean_ms([(s.at[4] - s.at[0]) + (s.at[2] - s.at[5]) for s in found])
