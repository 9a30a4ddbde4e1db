"""tiling.outside_generator.upscale: the share of a frame's wall time
outside the generator.

1 - (the generator calls' time between CUDA events recorded around each
call of the infer function the harness hands to ``tiled_upscale``) /
(the frames' host time, uint8 in to uint8 out).  What is left is tile
extraction, the blend, the uint8 conversion, the copies and the host's
glue.  Read over the traced part."""


def read(m):
    w = m.traced
    if w is None:
        return None
    if not w.get("generator_event_s") or not w.get("frame_wall_s"):
        return None
    return 100.0 * (1.0 - w["generator_event_s"] / w["frame_wall_s"])
