"""Device milliseconds a train step spends in the clip, Adam and the
zeroing of the gradients: phase mark 2 to mark 3
(``harness/phases.py``), over the traced window's complete steps
(rank 0)."""
from gnnbench.harness import phases

COMBINE = "rank0"


def read(run):
    return phases.phase_ms(run, "optimizer")
