"""SwinIR's operations and bytes from its widths: the multiply-adds per
LR pixel of the whole network (``mfu.swinir.upscale``) and the window
attention's roofline per window and head
(``window_attention.roofline.upscale``).

Per LR pixel (one token), per Swin layer: the four Linears (E·3E, E·E,
E·rE, rE·E) and the two attention products (w² keys at the published
head dim, E per product); per '3conv' stack (one per RSTB and
``conv_after_body``) 9·E·E/4 + (E/4)² + 9·E/4·E; ``conv_first`` 9·3·E;
``conv_before_upsample`` 9·E·F; the tail at 4 and 16 HR pixels per LR
pixel, 9·F·F (×4, ×16 for the two upsample convs, ×16 ``conv_hr``) and
9·F·3·16 ``conv_last``.  Norms, GELU, softmax and resampling are left
out.  SwinIR-L: 30,669,552 MACs, 61.34 MFLOP per LR pixel.
"""

from __future__ import annotations

from typing import Dict

from benchmark.lib.flops import PEAK_BYTES, PEAK_FLOPS


def macs_per_lr_px(cfg: Dict) -> Dict[str, int]:
    e, f, c = cfg["embed_dim"], cfg["num_feat"], cfg["in_chans"]
    hidden = int(e * cfg["mlp_ratio"])
    tokens = cfg["window_size"] ** 2
    layers = sum(cfg["depths"])
    q = e // 4
    three = 9 * e * q + q * q + 9 * q * e
    out = {"linears": layers * (e * 3 * e + e * e + 2 * e * hidden),
           "attention": layers * 2 * tokens * e,
           "three_conv": (len(cfg["depths"]) + 1) * three,
           "conv_first": 9 * c * e,
           "tail": 9 * e * f + 9 * f * f * (4 + 16 + 16) + 9 * f * c * 16}
    out["total"] = sum(out.values())
    return out


def flops_per_lr_px(cfg: Dict) -> float:
    return 2.0 * macs_per_lr_px(cfg)["total"]


def window_head_bound_s(cfg: Dict) -> float:
    """The roofline time of one window and head: the larger of
    4·w⁴·hd FLOP over the bf16 peak and the q, k, v read and the output
    written (4·w²·hd bf16 values) over HBM bandwidth."""
    tokens = cfg["window_size"] ** 2
    hd = cfg["embed_dim"] // cfg["num_heads"][0]
    flops = 4 * tokens * tokens * hd
    nbytes = 4 * tokens * hd * 2
    return max(flops / PEAK_FLOPS[cfg["compute_dtype"]], nbytes / PEAK_BYTES)
