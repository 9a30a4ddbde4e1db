"""Plain float32 RRDBNet ×4 (ESRGAN, arXiv 1809.00219 §3; Real-ESRGAN's
anime 6-block model is the same network at 6 blocks), and the tiled
upscale of one uint8 frame as the command-line upscale path defines it.

Network: a 3×3 stem conv; ``n_blocks`` residual-in-residual dense
blocks, each of ``n_dense`` dense blocks whose conv k reads the concat
of the block's input and every earlier conv's LeakyReLU(0.2) output, the
last conv back to ``filters`` channels, residual scale 0.2 on the dense
block and on the RRDB; a trunk conv with the global residual; per ×2
stage nearest upsampling, a conv and LeakyReLU; a conv with LeakyReLU
and the output conv.  Every conv is 3×3 with zero padding 1 and a bias.

Tiled upscale: the LR frame (uint8, 0..255) is scaled to [0, 1] and
normalised with the ImageNet mean and std; a grid of T×T tiles with
stride T − 2·halo covers it, the last row and column shifted inward so
every tile lies inside the frame (a frame that fits one tile runs
whole); each SR tile is weighted by a window that ramps linearly from 0
to 1 over 2·halo·scale HR pixels at each edge, the weighted tiles are
summed in row-major order onto the HR canvas, and the sum is divided by
the summed window weights; then denormalised, ×255, rounded half to
even and clamped to uint8.

``conv`` is ``F.conv2d``-like ``conv(x, w, b, stride)``; the plain
reference uses :func:`conv_f32` (float32, TF32 off); the control swaps
in a lower-precision conv (:mod:`benchmark.reference.lowp`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

Conv = Callable[..., torch.Tensor]
Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def full_float32():
    """TF32 off for convolutions and matrix products."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def conv_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             stride: int = 1) -> torch.Tensor:
    return F.conv2d(x, w, b, stride=stride, padding=1)


def generator(p: Params, cfg: Dict, x: torch.Tensor,
              conv: Conv = conv_f32) -> torch.Tensor:
    """NCHW float32 LR (normalised) -> NCHW float32 SR (normalised)."""
    slope, rs = cfg["lrelu_slope"], cfg["res_scale"]
    n = cfg["n_dense_convs"]

    def c(name, h):
        return conv(h, p[f"{name}.weight"], p[f"{name}.bias"])

    fea = c("conv_first", x)
    h = fea
    for i in range(cfg["n_blocks"]):
        rrdb_in = h
        for k in range(1, cfg["n_dense"] + 1):
            feats = block_in = h
            for j in range(1, n + 1):
                out = c(f"body.{i}.rdb{k}.conv{j}", feats)
                if j < n:
                    feats = torch.cat([feats, F.leaky_relu(out, slope)], 1)
            h = block_in + rs * out
        h = rrdb_in + rs * h
    fea = fea + c("conv_body", h)
    u = 1
    while f"conv_up{u}.weight" in p:
        if cfg["upsampler"] == "pixelshuffle":
            fea = F.pixel_shuffle(F.leaky_relu(c(f"conv_up{u}", fea), slope),
                                  2)
        else:
            fea = fea.repeat_interleave(2, 2).repeat_interleave(2, 3)
            fea = F.leaky_relu(c(f"conv_up{u}", fea), slope)
        u += 1
    fea = F.leaky_relu(c("conv_hr", fea), slope)
    return c("conv_last", fea)


# --------------------------------------------------------------------------
# The tiled upscale of one frame
# --------------------------------------------------------------------------

def offsets(n: int, tile: int, halo: int) -> List[int]:
    """Tile offsets along one axis of length n (tile already clamped)."""
    if n <= tile:
        return [0]
    stride = tile - 2 * halo
    k = math.ceil((n - tile) / stride) + 1
    return [min(i * stride, n - tile) for i in range(k)]


def ramp(t_hr: int, ramp_len: int, device) -> torch.Tensor:
    x = torch.arange(t_hr, dtype=torch.float32, device=device) + 0.5
    if ramp_len <= 0:
        return torch.ones_like(x)
    return torch.minimum((x / ramp_len).clamp(0, 1),
                         ((t_hr - x) / ramp_len).clamp(0, 1))


def upscale_frame(p: Params, cfg: Dict, lr_u8: torch.Tensor, tile: int,
                  halo: int, conv: Conv = conv_f32,
                  batch: int = 4) -> torch.Tensor:
    """(H, W, 3) uint8 on the device -> (H·r, W·r, 3) uint8."""
    r = cfg["scale"]
    dev = lr_u8.device
    mean = torch.tensor(cfg["normalize_mean"], device=dev)
    std = torch.tensor(cfg["normalize_std"], device=dev)
    x = ((lr_u8.float() / 255.0) - mean) / std            # (H, W, 3)
    h, w, _ = x.shape
    th, tw = min(tile, h), min(tile, w)

    def run(tiles: torch.Tensor) -> torch.Tensor:       # NHWC -> NHWC
        out = generator(p, cfg, tiles.permute(0, 3, 1, 2).contiguous(), conv)
        return out.permute(0, 2, 3, 1)

    with torch.no_grad(), full_float32():
        if h <= tile and w <= tile:
            sr = run(x[None])[0]
        else:
            oys, oxs = offsets(h, th, halo), offsets(w, tw, halo)
            grid = [(oy, ox) for oy in oys for ox in oxs]
            ramp_len = 2 * halo * r
            wy, wx = ramp(th * r, ramp_len, dev), ramp(tw * r, ramp_len, dev)
            window = (wy[:, None] * wx[None, :])[..., None]
            canvas = torch.zeros((h * r, w * r, 3), device=dev)
            py = torch.zeros(h * r, device=dev)
            px = torch.zeros(w * r, device=dev)
            for oy in oys:
                py[oy * r:(oy + th) * r] += wy
            for ox in oxs:
                px[ox * r:(ox + tw) * r] += wx
            for s in range(0, len(grid), batch):
                part = grid[s:s + batch]
                tiles = torch.stack([x[oy:oy + th, ox:ox + tw]
                                     for oy, ox in part])
                for t, (oy, ox) in zip(run(tiles), part):
                    canvas[oy * r:(oy + th) * r, ox * r:(ox + tw) * r] += \
                        t * window
            wmap = (py[:, None] * px[None, :])[..., None]
            sr = canvas / wmap.clamp_min(1e-8)
        y = sr * std + mean
        return torch.clamp(torch.round(y * 255.0), 0, 255).to(torch.uint8)

