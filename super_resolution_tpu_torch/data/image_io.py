"""Mode-preserving image IO for upscale and serve (the JAX package's
``data/image_io.py``).

The model sees only the RGB planes; an alpha plane (RGBA, LA, PA, or a
palette PNG with transparency) is upscaled separately with plain
PIL-parity bicubic and reattached, so transparency survives without the
generator hallucinating texture into a coverage mask.  Grayscale and
palette inputs are expanded to RGB for the model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from super_resolution_tpu_torch.ops.resize import bicubic_resize

__all__ = ["split_alpha", "upscale_alpha", "merge_alpha"]


def _has_alpha(im) -> bool:
    if im.mode in ("RGBA", "LA", "PA"):
        return True
    # palette PNGs carry transparency as a tRNS sidecar, not a band
    return im.mode == "P" and "transparency" in im.info


def split_alpha(im) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """PIL image → (HWC uint8 RGB, HW uint8 alpha or None)."""
    if _has_alpha(im):
        rgba = np.asarray(im.convert("RGBA"))
        return rgba[..., :3], rgba[..., 3]
    return np.asarray(im.convert("RGB")), None


def upscale_alpha(alpha_u8: np.ndarray, scale: int,
                  device: str | torch.device = "cuda") -> np.ndarray:
    """×``scale`` bicubic upscale of an HW uint8 alpha plane (uint8 out),
    computed on ``device``."""
    h, w = alpha_u8.shape
    a = torch.from_numpy(np.array(alpha_u8)).to(device)   # writable copy
    a = a.float()[..., None] / 255.0
    hr = bicubic_resize(a, h * scale, w * scale)[..., 0].cpu().numpy()
    return np.clip(np.rint(hr * 255.0), 0, 255).astype(np.uint8)


def merge_alpha(sr_rgb_u8: np.ndarray,
                alpha_u8: Optional[np.ndarray],
                scale: int,
                device: str | torch.device = "cuda") -> np.ndarray:
    """Reattach a (LR-resolution) alpha plane to an SR RGB frame: HWC
    uint8 with 4 channels when ``alpha_u8`` is given, else unchanged."""
    if alpha_u8 is None:
        return sr_rgb_u8
    alpha_hr = upscale_alpha(alpha_u8, scale, device)
    if alpha_hr.shape != sr_rgb_u8.shape[:2]:
        raise ValueError(
            f"alpha {alpha_u8.shape} × scale {scale} → {alpha_hr.shape} "
            f"does not match SR frame {sr_rgb_u8.shape[:2]}")
    return np.concatenate([sr_rgb_u8, alpha_hr[..., None]], axis=-1)
