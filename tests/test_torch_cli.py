"""The port's CLI (``super_resolution_tpu_torch.cli``) on the CPU: its
``upscale`` against the JAX package's ``cli upscale`` on the same PNG,
``.pth`` and tile flags, against its own direct generator forward, and
its ``serve`` against its ``upscale``.

The JAX comparison allows 1 uint8 LSB: two frameworks' float32 sums can
flip a .5 rounding.  Within the port the contracts are exact: a frame
that fits one tile gives 0 delta against the direct forward, and serve
writes the same bytes as upscale.
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from super_resolution_tpu.cli import main as jax_main
from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.config import DataConfig
from super_resolution_tpu_torch.data import (
    normalize,
    to_uint8_image,
    upscale_alpha,
)
from super_resolution_tpu_torch.import_torch import import_generator, load_pth
from super_resolution_tpu_torch.models.rrdb import RRDBNet
from torch_spec import RRDBNetTorch

CPU = ["--device", "cpu", "--dtype", "float32"]


def _frame(h, w, seed, alpha=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)],
                   -1) + rng.integers(-30, 31, (h, w, 3))
    planes = [np.clip(rgb, 0, 255)]
    if alpha:
        planes.append((128 + 120 * np.sin(xx / 5.0) * np.cos(yy / 7.0))
                      [..., None])
    return np.concatenate(planes, -1).astype(np.uint8)


def _save(tmp_path, name, arr):
    path = str(tmp_path / name)
    Image.fromarray(arr).save(path)
    return path


def _read(path):
    with Image.open(path) as im:
        return np.asarray(im)


@pytest.fixture
def pth(tmp_path):
    torch.manual_seed(0)
    sd = RRDBNetTorch(nf=16, nb=1, gc=8).state_dict()
    path = str(tmp_path / "gen.pth")
    torch.save(sd, path)
    return path


def _delta(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def test_upscale_matches_jax_cli(pth, tmp_path):
    src = _save(tmp_path, "lr.png", _frame(44, 60, 1))
    tiles = ["--tile", "32", "--halo", "6", "--tile_batch", "3"]
    port_out, jax_out = str(tmp_path / "p.png"), str(tmp_path / "j.png")
    assert main(["upscale", "--image", src, "--checkpoint", pth, "--out",
                 port_out, *tiles, *CPU]) == 0
    assert jax_main(["upscale", "--image", src, "--checkpoint", pth,
                     "--out", jax_out, "--dtype", "float32",
                     "--no_compile_cache", *tiles]) == 0
    got, ref = _read(port_out), _read(jax_out)
    assert got.shape == ref.shape == (176, 240, 3)
    assert _delta(got, ref) <= 1


def test_single_tile_upscale_equals_direct_forward(pth, tmp_path):
    """The border contract: a frame inside one tile runs whole, so the
    CLI's bytes are the direct forward's bytes."""
    lr = _frame(20, 28, 2)
    src = _save(tmp_path, "lr.png", lr)
    out = str(tmp_path / "sr.png")
    assert main(["upscale", "--image", src, "--checkpoint", pth, "--out",
                 out, *CPU]) == 0
    sd, gcfg = import_generator(load_pth(pth))
    model = RRDBNet(gcfg)
    model.load_state_dict(sd, strict=True)
    model.prepare(torch.float32)
    data = DataConfig()
    x = normalize(torch.from_numpy(lr).float() / 255.0,
                  data.normalize_mean, data.normalize_std)
    with torch.inference_mode():
        ref = to_uint8_image(model(x[None])[0], data).numpy()
    assert _delta(_read(out), ref) == 0


def test_params_ema_fp16_checkpoint_within_one_lsb(pth, tmp_path):
    sd = torch.load(pth, weights_only=True)
    ema = str(tmp_path / "ema.pth")
    torch.save({"params": sd,
                "params_ema": {k: v.half() for k, v in sd.items()}}, ema)
    src = _save(tmp_path, "lr.png", _frame(24, 32, 3))
    outs = []
    for ck in (pth, ema):
        outs.append(str(tmp_path / f"{os.path.basename(ck)}.png"))
        assert main(["upscale", "--image", src, "--checkpoint", ck,
                     "--out", outs[-1], *CPU]) == 0
    assert _delta(_read(outs[0]), _read(outs[1])) <= 1


def test_rgba_alpha_is_kept(pth, tmp_path):
    rgba = _frame(24, 20, 4, alpha=True)
    src = _save(tmp_path, "lr.png", rgba)
    out = str(tmp_path / "sr.png")
    jax_out = str(tmp_path / "j.png")
    assert main(["upscale", "--image", src, "--checkpoint", pth, "--out",
                 out, *CPU]) == 0
    assert jax_main(["upscale", "--image", src, "--checkpoint", pth,
                     "--out", jax_out, "--dtype", "float32",
                     "--no_compile_cache"]) == 0
    sr = _read(out)
    assert sr.shape == (96, 80, 4)
    np.testing.assert_array_equal(sr[..., 3],
                                  upscale_alpha(rgba[..., 3], 4, "cpu"))
    assert _delta(sr, _read(jax_out)) <= 1


def test_serve_once_matches_upscale_and_restarts_clean(pth, tmp_path,
                                                       capsys):
    watch = tmp_path / "in"
    watch.mkdir()
    frames = {"a": _frame(40, 36, 5), "b": _frame(22, 30, 6, alpha=True)}
    for k, img in frames.items():
        _save(watch, f"{k}.png", img)
    out_dir = str(tmp_path / "out")
    tiles = ["--tile", "24", "--halo", "4"]
    serve = ["serve", "--checkpoint", pth, "--watch", str(watch), "--out",
             out_dir, "--once", *tiles, *CPU]
    assert main(serve) == 0
    assert "processed 2 frames" in capsys.readouterr().out
    for k in frames:
        up = str(tmp_path / f"{k}_up.png")
        assert main(["upscale", "--image", str(watch / f"{k}.png"),
                     "--checkpoint", pth, "--out", up, *tiles, *CPU]) == 0
        np.testing.assert_array_equal(
            _read(os.path.join(out_dir, f"{k}_x4.png")), _read(up))
    assert _read(os.path.join(out_dir, "b_x4.png")).shape == (88, 120, 4)
    capsys.readouterr()
    assert main(serve) == 0
    assert "processed 0 frames" in capsys.readouterr().out


def test_upscale_directory_mode(pth, tmp_path):
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(2):
        _save(d, f"f{i}.png", _frame(12, 16, 10 + i))
    out = str(tmp_path / "sr")
    assert main(["upscale", "--image", str(d), "--checkpoint", pth,
                 "--out", out, *CPU]) == 0
    assert sorted(os.listdir(out)) == ["f0_x4.png", "f1_x4.png"]


def test_default_device_is_the_card(pth, tmp_path):
    """Without --device cpu the CLI asks for CUDA and raises where there
    is none; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    src = _save(tmp_path, "lr.png", _frame(8, 8, 7))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["upscale", "--image", src, "--checkpoint", pth, "--out",
              str(tmp_path / "sr.png"), "--dtype", "float32"])
    assert not os.path.exists(tmp_path / "sr.png")


@pytest.mark.parametrize("cmd,argv,err", [
    # two cards asked for: raises where there are fewer (no CPU fallback,
    # never two replicas on one card)
    ("upscale", ["--data_parallel", "2", "--device", "cuda"],
     (RuntimeError, ValueError)),
    # the grain loader without the grain package: raises, and never
    # trains on the threaded loader in its place
    ("train", ["--loader", "grain"], ImportError),
], ids=["data_parallel", "loader_grain"])
def test_unported_options_raise(pth, tmp_path, monkeypatch, cmd, argv,
                                err):
    if cmd == "upscale" and torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    if "grain" in argv:
        monkeypatch.setitem(sys.modules, "grain", None)
    src = _save(tmp_path, "lr.png", _frame(8, 8, 8))
    if cmd == "upscale":
        argv = ["upscale", "--image", src, "--checkpoint", pth, "--out",
                str(tmp_path / "sr.png"), *CPU, *argv]
    else:
        argv = ["train", "--dataset_dir", str(tmp_path), "--steps", "1",
                "--checkpoint_dir", str(tmp_path / "ck"), *CPU, *argv]
    with pytest.raises(err):
        main(argv)
    assert not os.path.exists(tmp_path / "sr.png")
    assert not os.path.exists(tmp_path / "ck")


def test_orbax_directory_is_refused(tmp_path):
    src = _save(tmp_path, "lr.png", _frame(8, 8, 9))
    ck = tmp_path / "ck"
    ck.mkdir()
    with pytest.raises(SystemExit, match="orbax"):
        main(["upscale", "--image", src, "--checkpoint", str(ck), "--out",
              str(tmp_path / "sr.png"), *CPU])
