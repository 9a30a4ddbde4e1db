"""mfu.upscale: the frames' share of the card's bf16 peak.

The LR pixels of every frame of the untraced window times the
configuration's FLOPs per LR pixel (from its widths), over the window's
seconds and the peak of the cards used.  It counts the work a frame
needs, whatever tiles or kernels compute it: overlap recomputed at tile
borders is not work.  The window, not the traced part, which the
profiler slows."""

from benchmark.lib.flops import PEAK_FLOPS, generator_flops_per_lr_px


def read(m):
    w = m.window
    if not w.get("frames"):
        return None
    flops = w["lr_px"] * generator_flops_per_lr_px(m.config)
    return 100.0 * flops / w["window_s"] / (
        PEAK_FLOPS[m.config["compute_dtype"]] * m.chips)
