"""Device milliseconds a train step spends in its forward: phase mark 0 to
mark 1 (``harness/phases.py``; the embedder, the message-passing
stack, the task head and the loss), over the traced window's complete
steps (rank 0)."""
from gnnbench.harness import phases

COMBINE = "rank0"


def read(run):
    return phases.phase_ms(run, "forward")
