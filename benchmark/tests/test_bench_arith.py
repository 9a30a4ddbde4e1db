"""The roofline and FLOP arithmetic against the figures PERF.md quotes,
and the configurations' parameter counts."""

import json
import math
import os

import pytest

from benchmark.lib import flops, weights

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_generator_flops_per_lr_pixel():
    assert flops.generator_flops_per_lr_px(
        config("esrgan_x4_rrdb23")) / 1e6 == pytest.approx(35.85, abs=0.005)
    macs = flops.generator_macs_per_lr_px(config("realesrgan_x4_anime6b"))
    assert macs["trunk"] / 1e6 == pytest.approx(4.31, abs=0.005)
    assert macs["total"] / 1e6 == pytest.approx(5.71, abs=0.005)


def test_flagship_batch_bound():
    per_px = flops.generator_flops_per_lr_px(config("esrgan_x4_rrdb23"))
    ms = 8 * 128 * 128 * per_px / flops.PEAK_FLOPS["bfloat16"] * 1e3
    assert ms == pytest.approx(4.752, abs=5e-4)


@pytest.mark.parametrize("fn,shape,ms", [
    (flops.block_bound, (8, 64, 128, 128), 0.0635),
    (flops.block_bound, (16, 64, 48, 48), 0.0179),
    (flops.bwd_bound, (16, 64, 48, 48), 0.0357),
])
def test_block_bounds(fn, shape, ms):
    got, by, _, _ = fn(shape, 32, "bfloat16")
    assert got == pytest.approx(ms, abs=5e-5) and by == "operations"


def test_tail_conv_bound_is_bytes_by_a_hair():
    ms, by, _, _ = flops.conv_bound((8, 512, 512, 64), 64, "bfloat16")
    assert ms == pytest.approx(0.160, abs=5e-4) and by == "bytes"


def test_gan_step_flops():
    parts = flops.gan_step_flops(config("esrgan_x4_rrdb23"), 16, 192)
    g_fwd = 16 * 48 * 48 * 35.853696e6
    assert parts["generator"] == pytest.approx(3 * g_fwd, rel=1e-3)
    assert parts["vgg"] / 1e12 == pytest.approx(1.376, abs=5e-4)
    assert parts["total"] == pytest.approx(
        parts["generator"] + parts["discriminator"] + parts["vgg"])


@pytest.mark.parametrize("name", ["esrgan_x4_rrdb23",
                                  "realesrgan_x4_anime6b"])
def test_parameter_counts(name):
    cfg = config(name)
    n = sum(math.prod(s) for _, s in weights.generator_shapes(cfg))
    assert n == cfg["parameters"]


def test_discriminator_and_vgg_counts():
    cfg = config("esrgan_x4_rrdb23")
    convs, norms = weights.discriminator_shapes(cfg)
    assert sum(math.prod(s) for _, s in convs + norms) == 4693697
    assert len(weights.vgg_shapes(cfg)) == 32
