"""Sub-pixel (pixel shuffle) and nearest-neighbour upsampling, NCHW.

The JAX package's versions (``ops/shuffle.py``) are NHWC; the port's
model runs NCHW inside, so these are their channels-first counterparts
with the same semantics: channel ``c·r·r + i·r + j`` goes to spatial
offset ``(i, j)`` (``torch.nn.PixelShuffle``), and nearest upsampling
replicates each pixel r×r.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, C·r·r, H, W) → (B, C, H·r, W·r)."""
    b, crr, h, w = x.shape
    if crr % (r * r):
        raise ValueError(f"{crr} channels do not split into r*r={r * r}")
    c = crr // (r * r)
    x = x.reshape(b, c, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, c, h * r, w * r)


def nearest_upsample(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, C, H, W) → (B, C, H·r, W·r) by pixel replication."""
    return x.repeat_interleave(r, dim=2).repeat_interleave(r, dim=3)
