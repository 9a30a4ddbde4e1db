"""The port's SwinIR (``models/swinir.py``, ``ops/window_attention.py``)
on the CPU, against the plain float32 reference ``swinir_reference.py``
(the published equations; nothing of either package).

Small seeded model: embed 60, 2 heads of 30, depths (2, 2), window 8,
'3conv', ×4, weights drawn by ``swinir_reference.released_state_dict``
at scales where attention, its bias and its mask move the output.
Frames of 20 × 28 (reflect-padded to 24 × 32) and 16 × 16, each through
shifted and unshifted layers.

Tolerances.  The port's plain path and the reference compute the same
float32 function in other orders (``conv3x3_plain``'s convs, the
1×1 conv as a Linear, the window partition by one permute): they agree
to about 3e-8 on outputs of order 0.03, so 1e-6 (``ATOL``) holds with
room, while each planted fault (the shift mask
dropped, the relative bias dropped, the cyclic shift skipped) moves the
output by 1e-4 or more.  ``window_attention_plain`` alone: values of
order 1, float32 sums of 64 terms in another order, 1e-5.  Within the
port, the CLI's contracts are exact (0 uint8 delta).
"""

import dataclasses
import importlib
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import swinir_reference as R
from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.config import (
    DIV2K_MEAN,
    UNIT_STD,
    GeneratorConfig,
    SwinIRConfig,
    preset,
)
from super_resolution_tpu_torch.data import normalize, to_uint8_image
from super_resolution_tpu_torch.import_torch import import_swinir, load_pth
from super_resolution_tpu_torch.metrics import recording, span_report
from super_resolution_tpu_torch.models import rrdb
from super_resolution_tpu_torch.models.swinir import SwinIR
from super_resolution_tpu_torch.ops.shuffle import (
    nearest_upsample,
    nearest_upsample_nhwc,
    pixel_shuffle,
    pixel_shuffle_nhwc,
)
from super_resolution_tpu_torch.parallel import tiled_upscale
from super_resolution_tpu_torch.train.steps import make_infer_fn

wa = importlib.import_module("super_resolution_tpu_torch.ops.window_attention")
sw = importlib.import_module("super_resolution_tpu_torch.models.swinir")

RCFG = dict(embed_dim=60, depths=(2, 2), num_heads=(2, 2), window_size=8,
            mlp_ratio=2.0, num_feat=64)
ATOL = 1e-6
CPU = ["--device", "cpu", "--dtype", "float32"]


@pytest.fixture(scope="module")
def released():
    return R.released_state_dict(RCFG, 3)


@pytest.fixture(scope="module")
def model(released):
    sd, cfg = import_swinir(released)
    m = SwinIR(cfg)
    m.load_state_dict(sd, strict=True)
    return m.prepare(torch.float32)


def _x(h, w, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(1, h, w, 3, generator=gen) - 0.45


def _ref(released, x):
    with torch.no_grad():
        return R.forward(released, RCFG, x.permute(0, 3, 1, 2)
                         ).permute(0, 2, 3, 1)


def _port(model, x):
    with torch.inference_mode():
        return model(x)


# --------------------------------------------------------------------------
# The attention alone
# --------------------------------------------------------------------------

def test_index_and_mask_are_the_published_ones():
    assert torch.equal(wa.relative_position_index(),
                       R.relative_position_index(8))
    for hp, wp in ((16, 24), (8, 8)):
        assert torch.equal(wa.shift_mask(hp, wp, 4),
                           R.calculate_mask(hp, wp, 8, 4))


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("hp,wp", [(16, 24), (8, 8)])
def test_window_attention_plain_matches_reference(shift, hp, wp):
    """The port's plain attention on the qkv Linear's output against the
    reference's roll, partition, attention (proj the identity) and
    reverse."""
    gen = torch.Generator().manual_seed(hp + shift)
    c, heads = 60, 2
    x = torch.randn(2, hp, wp, c, generator=gen)
    p = {"a.qkv.weight": torch.randn(3 * c, c, generator=gen) / c ** 0.5,
         "a.qkv.bias": torch.randn(3 * c, generator=gen),
         "a.proj.weight": torch.eye(c), "a.proj.bias": torch.zeros(c),
         "a.relative_position_bias_table": torch.randn(225, heads,
                                                       generator=gen)}
    y = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    win = R.window_partition(y, 8).view(-1, 64, c)
    mask = R.calculate_mask(hp, wp, 8, shift) if shift else None
    ref = R.window_reverse(R.attention(win, p, "a", heads, 8, mask)
                           .view(-1, 8, 8, c), 8, hp, wp)
    if shift:
        ref = torch.roll(ref, (shift, shift), (1, 2))
    qkv = F.linear(x, p["a.qkv.weight"], p["a.qkv.bias"])
    table = p["a.relative_position_bias_table"].t().contiguous()
    got = wa.window_attention(qkv, table, heads, shift)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    if shift:    # the mask matters in the last row and column of windows
        other = wa.window_attention(qkv, table, heads, 0)
        assert (other - ref).abs().max() > 100 * 1e-5


def test_window_attention_checks_its_input():
    qkv = torch.zeros(1, 12, 16, 180)
    with pytest.raises(ValueError, match="multiple of the window"):
        wa.window_attention(qkv, torch.zeros(2, 225), 2, 0)
    with pytest.raises(ValueError, match="shift"):
        wa.window_attention(torch.zeros(1, 8, 8, 180), torch.zeros(2, 225),
                            2, 8)


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(20, 28), (16, 16)])
def test_port_matches_reference(model, released, h, w):
    x = _x(h, w, h)
    ref = _ref(released, x)
    got = _port(model, x)
    assert got.shape == ref.shape == (1, 4 * h, 4 * w, 3)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)
    assert ref.abs().max() > 1e-2       # a frame that carries signal


@pytest.mark.parametrize("fault", ["mask", "bias", "shift"])
def test_planted_faults_fail_the_tolerance(model, released, monkeypatch,
                                           fault):
    """Each fault in the port's plain path, put where the program has the
    piece, moves the output past ``ATOL`` (by 100 times or more)."""
    if fault == "mask":
        monkeypatch.setattr(wa, "shift_mask",
                            lambda hp, wp, shift, device=None:
                            torch.zeros((hp // 8) * (wp // 8), 1, 1))
    elif fault == "bias":
        monkeypatch.setattr(wa, "relative_bias",
                            lambda table: torch.zeros(()))
    else:
        real = sw.window_attention
        monkeypatch.setattr(sw, "window_attention",
                            lambda qkv, table, heads, shift:
                            real(qkv, table, heads, 0))
    x = _x(20, 28, 20)
    err = (_port(model, x) - _ref(released, x)).abs().max()
    assert err > 100 * ATOL


def test_counters_and_spans(model):
    """20 × 28 pads to 24 × 32: 208 LR pixels, 12 windows of 2 heads a
    layer over 4 layers, 2 shifted launches, 2 RSTB spans."""
    with recording():
        _port(model, _x(20, 28, 1))
        r = span_report()
    assert r["counters"]["swinir.pad_px"] == 24 * 32 - 20 * 28
    assert r["counters"]["window_attention.windows"] == 12 * 2 * 4
    assert r["counters"]["window_attention.shifted"] == 2
    assert r["counters"]["launches.window_attention"] == 0   # the plain path
    assert r["spans"]["swinir.rstb"]["calls"] == 2


def test_import_maps_the_released_names(released, tmp_path):
    """Buffers dropped, the architecture read from the shapes, the rest
    loads strictly; ``params_ema`` unwrapped from a saved ``.pth``."""
    sd, cfg = import_swinir(released)
    assert cfg == SwinIRConfig(embed_dim=60, depths=(2, 2), num_heads=(2, 2))
    buffers = {k for k in released if k.endswith(("relative_position_index",
                                                  "attn_mask"))}
    assert len(buffers) == 4 + 2 and set(sd) == set(released) - buffers
    assert set(sd) == set(SwinIR(cfg).state_dict())
    path = str(tmp_path / "s.pth")
    torch.save({"params_ema": released}, path)
    sd2, cfg2 = import_swinir(load_pth(path))
    assert cfg2 == cfg and all(torch.equal(sd[k], sd2[k]) for k in sd)
    with pytest.raises(ValueError, match="architecture"):
        import_swinir(released, SwinIRConfig())


def test_import_refuses_other_windows(released):
    """The port runs 8×8 windows only: a checkpoint whose tables are not
    15² rows (here window 4's 7²) is refused when it is imported, not
    when it first runs."""
    other = {k: (v[:49] if k.endswith("relative_position_bias_table")
                 else v) for k, v in released.items()}
    with pytest.raises(ValueError, match="8x8 windows"):
        import_swinir(other)


def test_preset_and_normalisation():
    cfg = preset("swinir_l_real_x4")
    assert cfg.generator == SwinIRConfig()
    assert cfg.data.normalize_mean == DIV2K_MEAN == (0.4488, 0.4371, 0.4040)
    assert cfg.data.normalize_std == UNIT_STD
    assert SwinIRConfig().depths == (6,) * 9
    n = sum(p.numel() for p in SwinIR(SwinIRConfig(depths=(2,),
                                                   num_heads=(8,)))
            .parameters())
    # SwinIR-L's 28,013,059 less 8 RSTBs of 6 layers and 4 layers more
    per_layer = (2 * 240 + 225 * 8 + 240 * 720 + 720 + 240 * 240 + 240
                 + 2 * 240 + 240 * 480 + 480 + 480 * 240 + 240)
    per_rstb = 6 * per_layer + (9 * 240 * 60 + 60) + (60 * 60 + 60) \
        + (9 * 60 * 240 + 240)
    assert 28013059 - 8 * per_rstb - 4 * per_layer == n


def _tiled_reference(released, lr, tile, halo):
    """The reference tiled as the CLI tiles: clamped offsets, linear
    ramps over 2·halo·4 HR pixels, weighted sum over the summed
    weights."""
    h, w, _ = lr.shape
    th, tw = min(tile, h), min(tile, w)

    def offs(n, t):
        if n <= t:
            return [0]
        k = math.ceil((n - t) / (t - 2 * halo)) + 1
        return [min(i * (t - 2 * halo), n - t) for i in range(k)]

    def ramp(n):
        x = torch.arange(n, dtype=torch.float32) + 0.5
        return torch.minimum((x / (8 * halo)).clamp(0, 1),
                             ((n - x) / (8 * halo)).clamp(0, 1))

    wy, wx = ramp(4 * th), ramp(4 * tw)
    canvas = torch.zeros(4 * h, 4 * w, 3)
    wsum = torch.zeros(4 * h, 4 * w, 1)
    for oy in offs(h, th):
        for ox in offs(w, tw):
            t = _ref(released, lr[None, oy:oy + th, ox:ox + tw])[0]
            win = (wy[:, None] * wx[None, :])[..., None]
            canvas[4 * oy:4 * (oy + th), 4 * ox:4 * (ox + tw)] += t * win
            wsum[4 * oy:4 * (oy + th), 4 * ox:4 * (ox + tw)] += win
    return canvas / wsum


def test_tiled_upscale_matches_the_tiled_reference(released):
    sd, gcfg = import_swinir(released)
    cfg = dataclasses.replace(preset("swinir_l_real_x4"), generator=gcfg,
                              compute_dtype="float32")
    infer = make_infer_fn(cfg, sd, "cpu")
    lr = _x(40, 36, 7)[0]
    got = tiled_upscale(infer, lr, scale=4, tile=24, halo=4, tile_batch=2)
    ref = _tiled_reference(released, lr, 24, 4)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------

def _png(path, arr):
    Image.fromarray(arr).save(path)
    return str(path)


def _read(path):
    with Image.open(path) as im:
        return np.asarray(im)


def test_cli_upscale_and_serve_run_the_preset(released, tmp_path, capsys):
    """``upscale --preset swinir_l_real_x4``: 0 uint8 delta against the
    direct forward under the DIV2K normalisation; ``serve`` writes the
    same bytes; the other commands refuse the preset."""
    ck = str(tmp_path / "swinir.pth")
    torch.save({"params_ema": released}, ck)
    lr = (np.random.default_rng(0).random((20, 28, 3)) * 255).astype(np.uint8)
    watch = tmp_path / "in"
    watch.mkdir()
    src = _png(watch / "a.png", lr)
    out = str(tmp_path / "sr.png")
    flags = ["--preset", "swinir_l_real_x4", "--checkpoint", ck, *CPU]
    assert main(["upscale", "--image", src, "--out", out, *flags]) == 0
    sd, gcfg = import_swinir(released)
    m = SwinIR(gcfg)
    m.load_state_dict(sd)
    m.prepare(torch.float32)
    data = preset("swinir_l_real_x4").data
    x = normalize(torch.from_numpy(lr).float() / 255.0, data.normalize_mean,
                  data.normalize_std)
    ref = to_uint8_image(_port(m, x[None])[0], data).numpy()
    assert np.array_equal(_read(out), ref)
    out_dir = str(tmp_path / "out")
    assert main(["serve", "--watch", str(watch), "--out", out_dir, "--once",
                 *flags]) == 0
    assert "processed 1 frames" in capsys.readouterr().out
    assert np.array_equal(_read(os.path.join(out_dir, "a_x4.png")), ref)
    with pytest.raises(SystemExit, match="upscale and serve only"):
        main(["train", "--dataset_dir", "none", "--preset",
              "swinir_l_real_x4", *CPU])
    with pytest.raises(SystemExit, match="RRDBNet's architecture"):
        main(["upscale", "--image", src, "--out", out, "--residual_blocks",
              "2", *flags])


# --------------------------------------------------------------------------
# RRDBNet's tail after the move into models/tail.py
# --------------------------------------------------------------------------

def _tail_before_the_move(model, fea, trunk):
    """RRDBNet's tail as models/rrdb.py computed it inline before it
    moved into models/tail.py, the oracle of the move."""
    cfg, slope = model.cfg, model.cfg.lrelu_slope

    def on_nhwc(fn, x):
        return fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    if model.impl == "pallas_cf_tail":
        fea = model.conv_body.cf(trunk, False, slope) + fea
        for u in range(1, cfg.n_upsample + 1):
            conv = getattr(model, f"conv_up{u}")
            if model._polyphase:
                fea = F.leaky_relu(conv.up(fea), slope)
            elif cfg.upsampler == "nearest_conv":
                fea = conv.cf(on_nhwc(nearest_upsample_nhwc, fea), True,
                              slope)
            else:
                fea = on_nhwc(lambda t: pixel_shuffle_nhwc(t, 2),
                              conv.cf(fea, True, slope))
        return model.conv_last(model.conv_hr.cf(fea, True, slope))
    fea = fea + model.conv_body(trunk)
    for u in range(1, cfg.n_upsample + 1):
        conv = getattr(model, f"conv_up{u}")
        if model._polyphase:
            fea = F.leaky_relu(conv.up(fea), slope)
        elif cfg.upsampler == "nearest_conv":
            fea = F.leaky_relu(conv(nearest_upsample(fea, 2)), slope)
        else:
            fea = pixel_shuffle(F.leaky_relu(conv(fea), slope), 2)
    fea = F.leaky_relu(model.conv_hr(fea), slope)
    return model.conv_last(fea)


@pytest.mark.parametrize("impl,tail_up,upsampler", [
    ("auto", "naive", "nearest_conv"), ("pallas_cf_tail", "naive",
                                        "nearest_conv"),
    ("pallas_cf_tail", "naive", "pixelshuffle"),
    ("pallas_cf_tail", "polyphase", "nearest_conv"),
    ("lax", "naive", "pixelshuffle"), ("auto", "polyphase", "nearest_conv")])
def test_rrdb_tail_is_the_one_before_the_move(impl, tail_up, upsampler):
    cfg = GeneratorConfig(filters=16, growth=8, n_blocks=1, conv_impl=impl,
                          tail_up=tail_up, upsampler=upsampler,
                          init="torch_default")
    model = rrdb.RRDBNet(cfg).prepare(torch.float32)
    x = _x(12, 10, 3).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        fea = model.conv_first(x)
        trunk = model.trunk(fea)
        want = _tail_before_the_move(model, fea, trunk)
        got = model._forward_nchw(x)
    assert torch.equal(got, want)
