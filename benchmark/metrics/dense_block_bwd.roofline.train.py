"""dense_block_bwd.roofline.train: the dense-block backward's share of
its roofline over the traced window.

Every dense block's backward of every step (``flops.bwd_bound`` at the
step's LR batch: two products per conv; the feature buffer, cotangent
and weights read once, dx, dW and db written once) over the profiler's
device time of the kernels named in ``KERNELS``: the data gradient on
the Hopper tile with its backward epilogues, ``bwd_prep``,
``wgrad_wgmma`` and ``bwd_reduce`` (``csrc/dense_block_bwd.cu``), and
the float32 path's kernels."""

from benchmark.lib.flops import bwd_bound

KERNELS = (r"conv3x3_wgmma<[^>]*true>", r"\bbwd_prep\b", r"\bwgrad_wgmma\b",
           r"\bbwd_reduce\b", r"\bdgrad3x3\b", r"\bwgrad3x3\b",
           r"\bwgrad_reduce\b")


def read(m):
    w = m.traced
    if m.trace is None or not w.get("steps"):
        return None
    device_s = m.trace.kernel_seconds(KERNELS)
    if device_s <= 0:
        return None
    c = m.config
    lr = w["hr"] // c["scale"]
    per_step = c["n_blocks"] * c["n_dense"] * bwd_bound(
        (w["batch"], c["filters"], lr, lr), c["growth"], c["compute_dtype"],
        c["n_dense_convs"])[0]
    return 100.0 * w["steps"] * per_step / 1e3 / device_s
