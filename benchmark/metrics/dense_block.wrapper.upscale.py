"""dense_block.wrapper.upscale: the share of the dense-block op's
device time that is not its convolution kernels, over the traced
frames.

1 - the profiler's device time of the forward dense-block kernels
(``KERNELS``, the pattern of ``dense_block.roofline.upscale``) over
the device time of the program's ``ops.dense_block`` spans (timing
events around each call of ``ops/dense_block.dense_block`` on the
card): the feature buffer's copy and zero fill and the gaps between
the wrapper's launches."""

from benchmark.lib import spans

KERNELS = (r"conv3x3_wgmma<[^>]*false>",)


def read(m):
    r = spans.report(m)
    if r is None:
        return None
    op_s = spans.value(r, "ops.dense_block", "device_s")
    kernel_s = m.trace.kernel_seconds(KERNELS)
    if not op_s or kernel_s <= 0:
        return None
    return 100.0 * (1.0 - kernel_s / op_s)
