"""Host seconds the program spent building minibatches over the run: its
``ptgnn.model.tensorize``, ``ptgnn.model.extend_minibatch`` and
``ptgnn.model.finalize_minibatch`` spans (``core/model.py``), read from
``ptgnn_tpu_torch.utils.tracing.totals()`` in the run's own process (rank
0); nothing where the program keeps no such record."""
NAMES = ("ptgnn.model.tensorize", "ptgnn.model.extend_minibatch", "ptgnn.model.finalize_minibatch")
COMBINE = "rank0"


def read(run):
    try:
        from ptgnn_tpu_torch.utils import tracing
    except ImportError:
        return None
    found = tracing.totals()
    seconds = [found[name]["seconds"] for name in NAMES if name in found]
    return sum(seconds) if seconds else None
