"""Normalisation to and from the model's ImageNet-normalised space
(the inference half of the JAX package's ``data/augment.py``).  All
arithmetic is float32 on the tensor's device, in the JAX package's order,
so the uint8 result is the same bit for bit given the same model output;
``torch.round`` rounds half to even like ``jnp.round``."""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.config import DataConfig


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def denormalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return x * std + mean


def to_uint8_image(x_normalized: torch.Tensor,
                   cfg: DataConfig) -> torch.Tensor:
    """Denormalise a model output back to a displayable uint8 image."""
    x = denormalize(x_normalized, cfg.normalize_mean, cfg.normalize_std)
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)
