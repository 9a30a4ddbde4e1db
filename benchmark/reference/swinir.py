"""Plain float32 SwinIR ×4, 'nearest+conv' with '3conv' (Liang et al.,
arXiv 2108.10257; ``network_swinir.py`` as ``main_test_swinir.py``
builds it for ``real_sr``), and the tiled upscale of one uint8 frame as
the command-line upscale path defines it.

Network, on NCHW input already normalised (x − the DIV2K mean,
``img_range`` 1): reflect pad H and W up to multiples of the window;
``conv_first``; tokens and ``patch_embed.norm``; per RSTB, Swin layers
with cyclic shift 0 and w/2 in turn (LayerNorm, the qkv Linear,
``torch.roll`` by −s, window partition, per head
softmax(q·hd^−½·kᵀ + the relative bias gathered from the table by the
published index + ``calculate_mask``'s −100 mask)·v, the proj Linear,
window reverse, roll back, residual; LayerNorm, fc1, exact GELU, fc2,
residual), then the '3conv' stack on the map plus the RSTB's input;
``norm``; ``conv_after_body`` ('3conv') plus ``conv_first``'s output;
``conv_before_upsample`` with LeakyReLU 0.01; nearest ×2 and a conv with
LeakyReLU 0.2, twice; ``conv_hr`` with LeakyReLU 0.2; ``conv_last``; the
crop to ×4 the input.  LayerNorm eps 1e-5.

Tiled upscale: as :func:`reference.rrdbnet.upscale_frame` (its
``offsets`` and ``ramp``), with the DIV2K mean and unit std.

:class:`Ops` holds the products: float32 with TF32 off for the
reference; :func:`fp8_ops` gives the control, every conv, Linear,
q·kᵀ and P·v with its two operands in float8 e4m3 (one scale per
tensor) and float32 sums.  ``mask``, ``bias`` and ``shift`` False plant
the faults of the limits' readings: the shift mask dropped, the
relative bias dropped, the cyclic shift skipped.  Imports nothing of
the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from benchmark.reference.lowp import conv_fp8, round_fp8
from benchmark.reference.rrdbnet import full_float32, offsets, ramp

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-5
MASK_VALUE = -100.0


def _conv_f32(x, w, b, pad=1):
    return F.conv2d(x, w, b, padding=pad)


def _conv_fp8(x, w, b, pad=1):
    if pad == 1:
        return conv_fp8(x, w, b)
    return F.conv2d(round_fp8(x), round_fp8(w), b, padding=pad)


@dataclass
class Ops:
    conv: Callable = _conv_f32
    linear: Callable = F.linear
    matmul: Callable = torch.matmul
    mask: bool = True
    bias: bool = True
    shift: bool = True


def fp8_ops(**faults) -> Ops:
    return Ops(conv=_conv_fp8,
               linear=lambda x, w, b: F.linear(round_fp8(x), round_fp8(w),
                                               b),
               matmul=lambda a, b: round_fp8(a) @ round_fp8(b), **faults)


def relative_position_index(w: int, device=None) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(
        [torch.arange(w, device=device), torch.arange(w, device=device)],
        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    b, h, wd, c = x.shape
    x = x.view(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, w, w, c)


def window_reverse(win: torch.Tensor, w: int, h: int, wd: int
                   ) -> torch.Tensor:
    b = win.shape[0] // ((h // w) * (wd // w))
    x = win.view(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, wd, -1)


def calculate_mask(h: int, wd: int, w: int, s: int, device=None
                   ) -> torch.Tensor:
    img = torch.zeros((1, h, wd, 1), device=device)
    cuts = (slice(0, -w), slice(-w, -s), slice(-s, None))
    cnt = 0
    for hs in cuts:
        for ws in cuts:
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = window_partition(img, w).view(-1, w * w)
    mask = mw.unsqueeze(1) - mw.unsqueeze(2)
    return mask.masked_fill(mask != 0, MASK_VALUE).masked_fill(mask == 0,
                                                               0.0)


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def _attention(x, p, name, heads, w, mask, ops: Ops):
    bw, n, c = x.shape
    qkv = ops.linear(x, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"])
    q, k, v = qkv.reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    attn = ops.matmul(q * (c // heads) ** -0.5, k.transpose(-2, -1))
    if ops.bias:
        table = p[f"{name}.relative_position_bias_table"]
        idx = relative_position_index(w, table.device).view(-1)
        attn = attn + table[idx].view(n, n, -1).permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(bw // nw, nw, heads, n, n)
                + mask[None, :, None]).view(-1, heads, n, n)
    out = ops.matmul(torch.softmax(attn, dim=-1), v)
    out = out.transpose(1, 2).reshape(bw, n, c)
    return ops.linear(out, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"])


def _swin_layer(x, p, name, heads, w, s, h, wd, ops: Ops):
    b, _, c = x.shape
    s = s if ops.shift else 0
    y = _ln(x, p, f"{name}.norm1").view(b, h, wd, c)
    if s:
        y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
    mask = (calculate_mask(h, wd, w, s, x.device) if s and ops.mask
            else None)
    win = _attention(window_partition(y, w).view(-1, w * w, c), p,
                     f"{name}.attn", heads, w, mask, ops)
    y = window_reverse(win.view(-1, w, w, c), w, h, wd)
    if s:
        y = torch.roll(y, shifts=(s, s), dims=(1, 2))
    x = x + y.view(b, h * wd, c)
    y = _ln(x, p, f"{name}.norm2")
    y = ops.linear(y, p[f"{name}.mlp.fc1.weight"], p[f"{name}.mlp.fc1.bias"])
    y = ops.linear(F.gelu(y), p[f"{name}.mlp.fc2.weight"],
                   p[f"{name}.mlp.fc2.bias"])
    return x + y


def _conv(x, p, name, ops: Ops, pad=1):
    return ops.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], pad)


def _three_conv(x, p, name, ops: Ops):
    x = F.leaky_relu(_conv(x, p, f"{name}.0", ops), 0.2)
    x = F.leaky_relu(_conv(x, p, f"{name}.2", ops, pad=0), 0.2)
    return _conv(x, p, f"{name}.4", ops)


def generator(p: Params, cfg: Dict, x: torch.Tensor, ops: Ops = Ops()
              ) -> torch.Tensor:
    """NCHW float32 LR (normalised) -> NCHW float32 SR (normalised)."""
    w = cfg["window_size"]
    h0, w0 = x.shape[2:]
    x = F.pad(x, (0, -w0 % w, 0, -h0 % w), "reflect")
    b, _, h, wd = x.shape
    fea = _conv(x, p, "conv_first", ops)
    t = _ln(fea.flatten(2).transpose(1, 2), p, "patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(cfg["depths"],
                                           cfg["num_heads"])):
        t_in = t
        for j in range(depth):
            t = _swin_layer(t, p, f"layers.{i}.residual_group.blocks.{j}",
                            heads, w, 0 if j % 2 == 0 else w // 2, h, wd,
                            ops)
        m = _three_conv(t.transpose(1, 2).reshape(b, -1, h, wd), p,
                        f"layers.{i}.conv", ops)
        t = m.flatten(2).transpose(1, 2) + t_in
    t = _ln(t, p, "norm").transpose(1, 2).reshape(b, -1, h, wd)
    fea = _three_conv(t, p, "conv_after_body", ops) + fea
    fea = F.leaky_relu(_conv(fea, p, "conv_before_upsample.0", ops), 0.01)
    for u in (1, 2):
        fea = F.interpolate(fea, scale_factor=2, mode="nearest")
        fea = F.leaky_relu(_conv(fea, p, f"conv_up{u}", ops), 0.2)
    out = _conv(F.leaky_relu(_conv(fea, p, "conv_hr", ops), 0.2), p,
                "conv_last", ops)
    return out[:, :, :h0 * 4, :w0 * 4]


def upscale_frame(p: Params, cfg: Dict, lr_u8: torch.Tensor, tile: int,
                  halo: int, ops: Ops = Ops(), batch: int = 1
                  ) -> torch.Tensor:
    """(H, W, 3) uint8 on the device -> (4H, 4W, 3) uint8."""
    r = cfg["upscale"]
    dev = lr_u8.device
    mean = torch.tensor(cfg["normalize_mean"], device=dev)
    std = torch.tensor(cfg["normalize_std"], device=dev)
    x = ((lr_u8.float() / 255.0) - mean) / std            # (H, W, 3)
    h, w, _ = x.shape
    th, tw = min(tile, h), min(tile, w)

    def run(tiles: torch.Tensor) -> torch.Tensor:       # NHWC -> NHWC
        out = generator(p, cfg, tiles.permute(0, 3, 1, 2).contiguous(), ops)
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
