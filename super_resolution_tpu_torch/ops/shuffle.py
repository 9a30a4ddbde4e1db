"""Sub-pixel (pixel shuffle) and nearest-neighbour upsampling.

The JAX package's versions (``ops/shuffle.py``) are NHWC.  The port's
model runs NCHW inside under the channels-first conv paths, so
:func:`pixel_shuffle` and :func:`nearest_upsample` are their
channels-first counterparts; the ``_nhwc`` functions are the JAX
package's own, for the paths that run NHWC (and for a channels-last
tail, through its NHWC view).  Same semantics throughout: channel
``c·r·r + i·r + j`` goes to spatial offset ``(i, j)``
(``torch.nn.PixelShuffle``), and nearest upsampling replicates each
pixel r×r.
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


def pixel_shuffle_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C·r·r) → (B, H·r, W·r, C), contiguous."""
    b, h, w, crr = x.shape
    if crr % (r * r):
        raise ValueError(f"{crr} channels do not split into r*r={r * r}")
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def nearest_upsample_nhwc(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, H, W, C) → (B, H·r, W·r, C) by pixel replication, contiguous."""
    return x.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)
