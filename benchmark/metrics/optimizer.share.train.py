"""optimizer.share.train: the share of a GAN step's host time spent in
the two Adam updates and the EMA, over the traced steps.

The host time of the program's ``train.adam_g``, ``train.adam_d`` and
``train.ema`` spans over that of its ``train.gan_step`` spans.  Host
time, not device time: the step waits on its host, and the spans'
events would follow the host."""

from benchmark.lib import spans

PARTS = ("train.adam_g", "train.adam_d", "train.ema")


def read(m):
    r = spans.report(m)
    if r is None:
        return None
    step = spans.value(r, "train.gan_step", "host_s")
    parts = [spans.value(r, n, "host_s") for n in PARTS]
    if not step or None in parts:
        return None
    return 100.0 * sum(parts) / step
