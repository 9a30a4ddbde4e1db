"""swin_mlp.roofline.upscale: the MLP kernel's share of its roofline over
the traced frames.

The roofline time of every token the program ran through a Swin layer's
MLP (its counter ``swin_mlp.tokens``; per token the larger of 4·E·rE
FLOP over the bf16 peak and E read plus E written, 4·E bytes, over HBM
bandwidth: 0.4659 ns at SwinIR-L's 240 and 480, bound by operations)
over the profiler's device time of the kernel (``csrc/swin_mlp.cu``),
whose launches do not overlap (no programmatic dependent launch).  None
without the counter or the kernel, as on a program without the
kernel."""

from benchmark.lib import spans
from benchmark.lib.flops import PEAK_BYTES, PEAK_FLOPS

KERNELS = (r"\bswin_mlp_kernel\b",)


def token_bound_s(cfg) -> float:
    e = cfg["embed_dim"]
    hidden = int(e * cfg["mlp_ratio"])
    return max(4.0 * e * hidden / PEAK_FLOPS[cfg["compute_dtype"]],
               4.0 * e / PEAK_BYTES)


def read(m):
    r = spans.report(m)
    if r is None or "embed_dim" not in m.config:
        return None
    tokens = r["counters"].get("swin_mlp.tokens")
    device_s = m.trace.kernel_seconds(KERNELS)
    if not tokens or device_s <= 0:
        return None
    return 100.0 * tokens * token_bound_s(m.config) / device_s
