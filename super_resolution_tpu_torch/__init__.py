"""super_resolution_tpu_torch — the ESRGAN framework on PyTorch and CUDA for an NVIDIA H100.

The package's top level holds the configs, as the JAX package's does;
importing it builds no kernel and imports neither the models nor the
CLI.  The headline bench is ``python -m super_resolution_tpu_torch.bench``.
"""

__version__ = "0.1.0"

from super_resolution_tpu_torch.config import (  # noqa: F401
    DataConfig,
    DiscriminatorConfig,
    GeneratorConfig,
    LossConfig,
    OptimConfig,
    TrainConfig,
    VGGConfig,
)
