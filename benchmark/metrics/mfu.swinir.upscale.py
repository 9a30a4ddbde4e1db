"""mfu.swinir.upscale: the SwinIR frames' share of the card's bf16 peak.

The LR pixels of every frame of the untraced window times SwinIR's
FLOPs per LR pixel from its widths (``flops_swinir.flops_per_lr_px``,
61.34 MFLOP for SwinIR-L, attention at the published head dim 30), over
the window's seconds and the peak of the cards used.  Overlap recomputed
at tile borders and the reflect pad are not counted."""

from benchmark.lib.flops import PEAK_FLOPS
from benchmark.lib.flops_swinir import flops_per_lr_px


def read(m):
    w = m.window
    if not w.get("frames") or "embed_dim" not in m.config:
        return None
    flops = w["lr_px"] * flops_per_lr_px(m.config)
    return 100.0 * flops / w["window_s"] / (
        PEAK_FLOPS[m.config["compute_dtype"]] * m.chips)
