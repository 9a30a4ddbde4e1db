"""device_idle.upscale: the share of the traced window of frames in
which no kernel, copy or set ran on the card."""


def read(m):
    if m.trace is None or m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
