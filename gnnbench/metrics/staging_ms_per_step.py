"""Device milliseconds between a train step's graph and the next: phase
mark 3 to the next step's mark 0 (``harness/phases.py``): the copies
of the next minibatch into the static buffers, the rates' fill, the
generator's seed and offset, the graph's launch, and any idle between
them, over the traced window's complete steps (rank 0)."""
from gnnbench.harness import phases

COMBINE = "rank0"


def read(run):
    return phases.phase_ms(run, "staging")
