"""window_attention.roofline.upscale: the window-attention kernel's share
of its roofline over the traced frames.

The roofline time of every window and head the program computed (its
counter ``window_attention.windows``; per window-head the larger of
4·64²·30 FLOP over the bf16 peak and the q, k, v read and the output
written over HBM bandwidth, ``flops_swinir.window_head_bound_s``) over
the profiler's device time of the kernel (``csrc/
window_attention.cu``), whose launches do not overlap (no programmatic
dependent launch).  None without the counter or the kernel."""

from benchmark.lib import spans
from benchmark.lib.flops_swinir import window_head_bound_s

KERNELS = (r"\bwindow_attention_kernel\b",)


def read(m):
    r = spans.report(m)
    if r is None:
        return None
    windows = r["counters"].get("window_attention.windows")
    device_s = m.trace.kernel_seconds(KERNELS)
    if not windows or device_s <= 0:
        return None
    return 100.0 * windows * window_head_bound_s(m.config) / device_s
