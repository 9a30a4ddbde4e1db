"""window_attention.share.upscale: the share of a frame's wall time the
window attention takes, over the traced frames.

The device time of the program's ``ops.window_attention`` spans (timing
events around each launch) over the frames' host time, uint8 in to
uint8 out."""

from benchmark.lib import spans


def read(m):
    r = spans.report(m)
    if r is None or not m.traced or not m.traced.get("frame_wall_s"):
        return None
    op_s = spans.value(r, "ops.window_attention", "device_s")
    if op_s is None:
        return None
    return 100.0 * op_s / m.traced["frame_wall_s"]
