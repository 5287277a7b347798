"""The benchmark of ptgnn_tpu_torch, the PyTorch and CUDA port: see README.md."""
