"""mfu.train: the GAN steps' share of the cards' bf16 peak.

The model FLOPs of one step from its shapes (``flops.gan_step_flops``:
G's forward and backward, D's four forwards and three backwards, VGG's
two forwards and its backward into SR; convolutions only) times the
steps of the untraced window, over its seconds and the peak of the
cards used.  The window, not the traced part: the profiler slows the
host-bound step (PERF.md gives by how much)."""

from benchmark.lib.flops import PEAK_FLOPS


def read(m):
    w = m.window
    if not w.get("steps"):
        return None
    return 100.0 * w["steps"] * w["step_flops"] / w["window_s"] / (
        PEAK_FLOPS[m.config["compute_dtype"]] * m.chips)
