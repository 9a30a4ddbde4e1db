"""A plain float32 SwinIR ×4 ('nearest+conv', '3conv') for the tests:
the equations of Liang et al., arXiv 2108.10257, as SwinIR's
``network_swinir.py`` computes them, over a state dict with the released
checkpoint's names.  TESTS-ONLY, and independent of both packages: it
imports neither.

``forward(p, cfg, x)`` takes NCHW float32 input already normalised
(x − mean, ``img_range`` 1) and returns NCHW output in the same space:
reflect pad to multiples of the window, ``conv_first``, LayerNorm, the
RSTBs (Swin layers with ``torch.roll`` by −s, window partition, the
index-gathered relative bias, ``calculate_mask``'s −100 mask, exact
GELU; then '3conv' and the RSTB's residual), LayerNorm,
``conv_after_body`` plus ``conv_first``'s output,
``conv_before_upsample`` with LeakyReLU 0.01, nearest ×2 and a conv with
LeakyReLU 0.2 twice, ``conv_hr`` with LeakyReLU 0.2, ``conv_last``, and
the crop.  ``cfg`` is a dict: ``embed_dim``, ``depths``, ``num_heads``,
``window_size``, ``mlp_ratio``, ``num_feat``.

``released_state_dict(cfg, seed)`` draws seeded weights under the
released names, buffers included (``relative_position_index`` of every
layer, ``attn_mask`` of the shifted ones at ``img_size`` 64), as a
SwinIR ``.pth`` holds them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def relative_position_index(w: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(w), torch.arange(w)],
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
    b = int(win.shape[0] / (h * wd / w / w))
    x = win.view(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, wd, -1)


def calculate_mask(h: int, wd: int, w: int, s: int) -> torch.Tensor:
    img = torch.zeros((1, h, wd, 1))
    cuts = (slice(0, -w), slice(-w, -s), slice(-s, None))
    cnt = 0
    for hs in cuts:
        for ws in cuts:
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = window_partition(img, w).view(-1, w * w)
    mask = mw.unsqueeze(1) - mw.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def _lin(x, p, name):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _conv(x, p, name, pad=1):
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], padding=pad)


def attention(x, p, name, heads, w, mask):
    bw, n, c = x.shape
    qkv = _lin(x, p, f"{name}.qkv").reshape(bw, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    table = p[f"{name}.relative_position_bias_table"]
    bias = table[relative_position_index(w).view(-1)].view(n, n, -1)
    attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) + mask[None, :, None]
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
    return _lin(out, p, f"{name}.proj")


def swin_layer(x, p, name, heads, w, s, h, wd):
    b, _, c = x.shape
    sc = x
    x = _ln(x, p, f"{name}.norm1").view(b, h, wd, c)
    if s:
        x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
    win = window_partition(x, w).view(-1, w * w, c)
    mask = calculate_mask(h, wd, w, s).to(x.device) if s else None
    win = attention(win, p, f"{name}.attn", heads, w, mask)
    x = window_reverse(win.view(-1, w, w, c), w, h, wd)
    if s:
        x = torch.roll(x, shifts=(s, s), dims=(1, 2))
    x = sc + x.view(b, h * wd, c)
    y = _lin(F.gelu(_lin(_ln(x, p, f"{name}.norm2"), p, f"{name}.mlp.fc1")),
             p, f"{name}.mlp.fc2")
    return x + y


def three_conv(x, p, name):
    x = F.leaky_relu(_conv(x, p, f"{name}.0"), 0.2)
    x = F.leaky_relu(_conv(x, p, f"{name}.2", pad=0), 0.2)
    return _conv(x, p, f"{name}.4")


def forward(p: Dict[str, torch.Tensor], cfg: Dict, x: torch.Tensor
            ) -> torch.Tensor:
    """NCHW normalised LR → NCHW normalised SR, float32."""
    w = cfg["window_size"]
    h0, w0 = x.shape[2:]
    x = F.pad(x, (0, -w0 % w, 0, -h0 % w), "reflect")
    b, _, h, wd = x.shape
    fea = _conv(x, p, "conv_first")
    t = _ln(fea.flatten(2).transpose(1, 2), p, "patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(cfg["depths"],
                                           cfg["num_heads"])):
        t_in = t
        for j in range(depth):
            t = swin_layer(t, p, f"layers.{i}.residual_group.blocks.{j}",
                           heads, w, 0 if j % 2 == 0 else w // 2, h, wd)
        m = t.transpose(1, 2).view(b, -1, h, wd)
        t = three_conv(m, p, f"layers.{i}.conv").flatten(2).transpose(1, 2) \
            + t_in
    t = _ln(t, p, "norm").transpose(1, 2).view(b, -1, h, wd)
    fea = three_conv(t, p, "conv_after_body") + fea
    fea = F.leaky_relu(_conv(fea, p, "conv_before_upsample.0"), 0.01)
    for u in (1, 2):
        fea = F.interpolate(fea, scale_factor=2, mode="nearest")
        fea = F.leaky_relu(_conv(fea, p, f"conv_up{u}"), 0.2)
    out = _conv(F.leaky_relu(_conv(fea, p, "conv_hr"), 0.2), p, "conv_last")
    return out[:, :, :h0 * 4, :w0 * 4]


def released_state_dict(cfg: Dict, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded weights under the released names, with the buffers.
    Linears and the tables are drawn at scales large enough that every
    layer moves the output (std 1/√fan_in and 1), convs uniform by
    nn.Conv2d's bound, LayerNorms near 1 and 0."""
    gen = torch.Generator().manual_seed(seed)
    e, nf, w = cfg["embed_dim"], cfg["num_feat"], cfg["window_size"]
    p: Dict[str, torch.Tensor] = {}

    def conv(name, cin, cout, k=3):
        bound = 1.0 / math.sqrt(cin * k * k)
        p[f"{name}.weight"] = (torch.rand(cout, cin, k, k, generator=gen)
                               * 2 - 1) * bound
        p[f"{name}.bias"] = (torch.rand(cout, generator=gen) * 2 - 1) * bound

    def lin(name, cin, cout):
        p[f"{name}.weight"] = torch.randn(cout, cin, generator=gen) \
            / math.sqrt(cin)
        p[f"{name}.bias"] = torch.randn(cout, generator=gen) * 0.1

    def ln(name, c):
        p[f"{name}.weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
        p[f"{name}.bias"] = 0.1 * torch.randn(c, generator=gen)

    def three(name, c):
        conv(f"{name}.0", c, c // 4)
        conv(f"{name}.2", c // 4, c // 4, 1)
        conv(f"{name}.4", c // 4, c)

    conv("conv_first", 3, e)
    ln("patch_embed.norm", e)
    hidden = int(e * cfg["mlp_ratio"])
    for i, (depth, heads) in enumerate(zip(cfg["depths"],
                                           cfg["num_heads"])):
        for j in range(depth):
            n = f"layers.{i}.residual_group.blocks.{j}"
            ln(f"{n}.norm1", e)
            p[f"{n}.attn.relative_position_bias_table"] = torch.randn(
                (2 * w - 1) ** 2, heads, generator=gen)
            p[f"{n}.attn.relative_position_index"] = \
                relative_position_index(w)
            lin(f"{n}.attn.qkv", e, 3 * e)
            lin(f"{n}.attn.proj", e, e)
            ln(f"{n}.norm2", e)
            lin(f"{n}.mlp.fc1", e, hidden)
            lin(f"{n}.mlp.fc2", hidden, e)
            if j % 2:
                p[f"{n}.attn_mask"] = calculate_mask(64, 64, w, w // 2)
        three(f"layers.{i}.conv", e)
    ln("norm", e)
    three("conv_after_body", e)
    conv("conv_before_upsample.0", e, nf)
    for name in ("conv_up1", "conv_up2", "conv_hr"):
        conv(name, nf, nf)
    conv("conv_last", nf, 3)
    return p
