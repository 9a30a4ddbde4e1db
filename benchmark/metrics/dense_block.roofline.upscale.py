"""dense_block.roofline.upscale: the dense-block kernel's share of its
roofline over the traced window.

The roofline time of every dense block of every generator call (the
larger of operations over the bf16 peak and bytes over HBM bandwidth,
``flops.block_bound``, at each call's tile batch) over the profiler's
device time of the kernels named in ``KERNELS``: the Hopper tile's
forward instantiations, which under ``conv_impl="auto"`` run the dense
blocks alone (``csrc/dense_block.cu``)."""

from benchmark.lib.flops import block_bound

KERNELS = (r"conv3x3_wgmma<[^>]*false>",)


def read(m):
    if m.trace is None or not m.traced.get("calls"):
        return None
    device_s = m.trace.kernel_seconds(KERNELS)
    if device_s <= 0:
        return None
    c = m.config
    blocks = c["n_blocks"] * c["n_dense"]
    bound_ms = sum(blocks * block_bound((b, c["filters"], h, w), c["growth"],
                                        c["compute_dtype"],
                                        c["n_dense_convs"])[0]
                   for b, h, w in m.traced["calls"])
    return 100.0 * bound_ms / 1e3 / device_s
