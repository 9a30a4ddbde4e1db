"""Self-ensemble (×8 test-time augmentation, the JAX package's
``ops/ensemble.py``): average the SR results over the 8 dihedral
transforms of the input, inverting each transform on the output."""

from __future__ import annotations

from typing import Callable

import torch


def _dihedral(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th (0..7) dihedral transform of an (H, W, C) image."""
    if k >= 4:
        x = torch.flip(x, dims=(1,))
    return torch.rot90(x, k % 4, dims=(0, 1))


def _dihedral_inv(x: torch.Tensor, k: int) -> torch.Tensor:
    x = torch.rot90(x, -(k % 4), dims=(0, 1))
    if k >= 4:
        x = torch.flip(x, dims=(1,))
    return x


def self_ensemble(upscale_fn: Callable[[torch.Tensor], torch.Tensor],
                  lr: torch.Tensor) -> torch.Tensor:
    """×8 TTA around any (H, W, C) → (rH, rW, C) upscale function."""
    acc = None
    for k in range(8):
        sr = _dihedral_inv(upscale_fn(_dihedral(lr, k).contiguous()), k)
        acc = sr if acc is None else acc + sr
    return acc / 8.0
