"""super_resolution_tpu_torch — the ESRGAN framework on PyTorch and CUDA for an NVIDIA H100."""
