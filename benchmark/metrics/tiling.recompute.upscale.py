"""tiling.recompute.upscale: the generator's LR pixels per frame pixel
over the traced frames.

The program's counters (``parallel/tiling.tiled_upscale``):
``tiling.generator_lr_px`` (every tile's LR pixels, or the frame's
when it runs whole) over ``tiling.frame_lr_px``.  1 is no overlap; the
excess is the halo and the clamped last row and column of tiles, work
that ``mfu.upscale`` does not count.  A count: the same on every run of
a cell whose traced part holds whole cycles of its mix."""

from benchmark.lib import spans


def read(m):
    r = spans.report(m)
    if r is None:
        return None
    frame = r["counters"].get("tiling.frame_lr_px")
    generator = r["counters"].get("tiling.generator_lr_px")
    if not frame or not generator:
        return None
    return generator / frame
