"""PIL-parity bicubic resampling as two matmuls (the JAX package's
``ops/resize.py``): PIL's resampling weights (Catmull-Rom cubic,
a = -0.5, support scaled by the downscale factor, rows normalised) are
built as (out, in) float32 matrices on the host and applied to the rows,
then the columns, in float32 (no TF32)."""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax < 1.0,
        ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
        np.where(ax < 2.0, (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def _resample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """PIL ``precompute_coeffs`` equivalent: (n_out, n_in) float32
    weights.  Cached: callers must not write to the returned array."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale          # bicubic support = 2
    ss = 1.0 / filterscale
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(n_in, int(center + support + 0.5))
        xs = np.arange(xmin, xmax, dtype=np.float64)
        w = _cubic((xs - center + 0.5) * ss)
        s = w.sum()
        if s != 0.0:
            w = w / s
        mat[i, xmin:xmax] = w
    return mat.astype(np.float32)


def bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize an NHWC (or HWC) float32 tensor to (out_h, out_w),
    PIL-bicubic, on the tensor's device."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    mh = torch.from_numpy(_resample_matrix(h, out_h)).to(x.device)
    mw = torch.from_numpy(_resample_matrix(w, out_w)).to(x.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = torch.einsum("oh,bhwc->bowc", mh, x)
        y = torch.einsum("ow,bhwc->bhoc", mw, y)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return y[0] if squeeze else y


def bicubic_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """÷factor antialiased bicubic downsample of NHWC (or HWC) ``x``: the
    LR synthesis of training."""
    h, w = x.shape[-3], x.shape[-2]
    if h % factor or w % factor:
        raise ValueError(f"shape {tuple(x.shape)} does not divide by "
                         f"{factor}")
    return bicubic_resize(x, h // factor, w // factor)
