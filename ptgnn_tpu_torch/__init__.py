"""ptgnn_tpu_torch: the PyTorch/CUDA port of ptgnn_tpu for NVIDIA Hopper.

The module layout mirrors ``ptgnn_tpu`` so that each counterpart is easy to
find. Plain tensor code is PyTorch; every Pallas kernel of the JAX package on
a ported path is a CUDA C++ kernel under ``csrc/``, built at first use. Entry
points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version instead.
"""
from ptgnn_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
