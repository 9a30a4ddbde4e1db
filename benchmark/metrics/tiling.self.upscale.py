"""tiling.self.upscale: the tiling's own share of a frame's wall time
over the traced frames.

The device time of the program's ``tiling.tiled_upscale`` spans less
that of their ``tiling.generator`` children (timing events on the
stream; the frame cells keep the card busy, so an event interval is
its work's device time): tile extraction, the tiles' concatenation and
the blend, over the frames' host time, uint8 in to uint8 out.  What
``tiling.outside_generator.upscale`` counts beyond it is the uint8
glue and the copy to the host."""

from benchmark.lib import spans


def read(m):
    r = spans.report(m)
    if r is None or not m.traced or not m.traced.get("frame_wall_s"):
        return None
    whole = spans.value(r, "tiling.tiled_upscale", "device_s")
    generator = spans.value(r, "tiling.generator", "device_s")
    if whole is None or generator is None:
        return None
    return 100.0 * (whole - generator) / m.traced["frame_wall_s"]
