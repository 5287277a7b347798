"""ptgnn_tpu_torch: the PyTorch/CUDA port of ptgnn_tpu for NVIDIA Hopper.

The module layout mirrors ``ptgnn_tpu`` so that each counterpart is easy to
find. Plain tensor code is PyTorch; every Pallas kernel of the JAX package on
a ported path is a CUDA C++ kernel under ``csrc/``, built at first use. Entry
points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version instead.
"""
__version__ = "0.2.0"

from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.core.trainer import ModelTrainer
from ptgnn_tpu_torch.device import resolve_device
from ptgnn_tpu_torch.nn.module import Module

__all__ = ["AbstractNeuralModel", "ModelTrainer", "Module", "__version__", "resolve_device"]
