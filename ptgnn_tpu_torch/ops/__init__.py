from ptgnn_tpu_torch.ops.segment import (
    segment_argmax,
    segment_count,
    segment_log_softmax,
    segment_logsumexp,
    segment_max,
    segment_mean,
    segment_min,
    segment_reduce,
    segment_softmax,
    segment_sum,
)

__all__ = [
    "segment_argmax",
    "segment_count",
    "segment_log_softmax",
    "segment_logsumexp",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_reduce",
    "segment_softmax",
    "segment_sum",
]
