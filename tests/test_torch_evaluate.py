"""The port's eval (``train/evaluate.py``, ``cli eval``, in-loop eval)
against the JAX package's ``evaluate_directory`` on the CPU.

One seeded torch-spec ``.pth`` (nb = 1, nf = 16, gc = 8) loads into both
packages, float32.  The validation images are at most 64 x 64 HR, the
tile geometry (8 x 8 LR tiles, halo 2) really tiles them, and each mode
is run: bicubic LR synthesis, paired ``lr_dir``, self-ensemble and
``max_images``.  Tolerance per image mean: 1e-3 dB PSNR and 1e-5 SSIM;
the two generators agree to float32 summation order (``test_parity``'s
2e-5), which moves these by orders of magnitude less.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

from super_resolution_tpu.config import TrainConfig as JTrainConfig
from super_resolution_tpu.import_torch import (
    import_generator as jax_import_generator,
)
from super_resolution_tpu.import_torch import load_pth as jax_load_pth
from super_resolution_tpu.train.evaluate import (
    evaluate_directory as jax_evaluate_directory,
)
from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.config import TrainConfig
from super_resolution_tpu_torch.import_torch import import_generator, load_pth
from super_resolution_tpu_torch.train.evaluate import evaluate_directory
from torch_spec import RRDBNetTorch

TILES = dict(tile=8, halo=2, tile_batch=4)
PSNR_ATOL, SSIM_ATOL = 1e-3, 1e-5
HR_SIZES = {"a": (64, 64), "b": (48, 60), "c": (40, 44)}
# paired LR sizes: b's HR (48 x 60) is cropped to 48 x 56 by its LR
LR_SIZES = {"a": (16, 16), "b": (12, 14), "c": (10, 11)}


def _img(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([xx * 255 // w, yy * 255 // h,
                    128 + 100 * np.sin(xx / 3.0) * np.cos(yy / 5.0)], -1)
    rgb = rgb + rng.integers(-25, 26, (h, w, 3))
    return np.clip(rgb, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    torch.manual_seed(0)
    pth = str(root / "gen.pth")
    torch.save(RRDBNetTorch(nf=16, nb=1, gc=8).state_dict(), pth)
    (root / "hr").mkdir()
    (root / "lr").mkdir()
    for i, (k, (h, w)) in enumerate(sorted(HR_SIZES.items())):
        Image.fromarray(_img(h, w, i)).save(root / "hr" / f"{k}.png")
        lh, lw = LR_SIZES[k]
        Image.fromarray(_img(lh, lw, 10 + i)).save(root / "lr" / f"{k}.png")

    sd, gcfg = import_generator(load_pth(pth))
    cfg = dataclasses.replace(TrainConfig(), generator=gcfg,
                              compute_dtype="float32")
    jv, jgcfg = jax_import_generator(jax_load_pth(pth))
    jcfg = dataclasses.replace(JTrainConfig(), generator=jgcfg,
                               compute_dtype="float32")
    return dict(root=root, pth=pth, sd=sd, cfg=cfg, jparams=jv["params"],
                jcfg=jcfg)


def _close(got, ref):
    assert set(got) == set(ref) == {"psnr_rgb", "psnr_y", "ssim",
                                    "n_images"}
    assert got["n_images"] == ref["n_images"]
    for k in ("psnr_rgb", "psnr_y"):
        assert got[k] == pytest.approx(ref[k], abs=PSNR_ATOL), k
    assert got["ssim"] == pytest.approx(ref["ssim"], abs=SSIM_ATOL)


MODES = {
    "bicubic": {},
    "paired": {"lr_dir": "lr"},
    "self_ensemble": {"use_self_ensemble": True, "max_images": 1},
    "max_images": {"max_images": 1},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_matches_jax(setup, mode):
    kw = dict(MODES[mode])
    if "lr_dir" in kw:
        kw["lr_dir"] = str(setup["root"] / kw["lr_dir"])
    val = str(setup["root"] / "hr")
    got = evaluate_directory(setup["cfg"], setup["sd"], val, device="cpu",
                             **TILES, **kw)
    ref = jax_evaluate_directory(setup["jcfg"], setup["jparams"], val,
                                 **TILES, **kw)
    _close(got, ref)
    assert got["n_images"] == kw.get("max_images", len(HR_SIZES))


def test_paired_hr_smaller_than_lr_raises(setup, tmp_path):
    (tmp_path / "hr").mkdir()
    Image.fromarray(_img(40, 40, 3)).save(tmp_path / "hr" / "a.png")
    with pytest.raises(ValueError, match="smaller than"):
        evaluate_directory(setup["cfg"], setup["sd"], str(tmp_path / "hr"),
                           lr_dir=str(setup["root"] / "lr"), device="cpu",
                           **TILES)


def test_cli_eval_json_prints_the_functions_numbers(setup, capsys):
    val = str(setup["root"] / "hr")
    want = evaluate_directory(setup["cfg"], setup["sd"], val, device="cpu",
                              **TILES)
    capsys.readouterr()
    assert main(["eval", "--dataset_dir", val, "--checkpoint", setup["pth"],
                 "--json", "--tile", "8", "--halo", "2", "--tile_batch",
                 "4", "--device", "cpu", "--dtype", "float32"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    # without --json: key: value lines, and --halo auto falls back to 8
    assert main(["eval", "--dataset_dir", val, "--checkpoint", setup["pth"],
                 "--tile", "24", "--device", "cpu", "--dtype",
                 "float32"]) == 0
    out = capsys.readouterr().out
    assert "using conservative halo=8" in out
    assert "n_images: 3" in out and "psnr_rgb: " in out


def test_cli_eval_default_device_is_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["eval", "--dataset_dir", str(setup["root"] / "hr"),
              "--checkpoint", setup["pth"], "--dtype", "float32"])


def test_cli_train_eval_dir_logs_val_metrics(setup, tmp_path):
    log = tmp_path / "log"
    assert main(["train", "--dataset_dir", "/nonexistent/synthetic",
                 "--checkpoint_dir", str(tmp_path / "ck"), "--device",
                 "cpu", "--dtype", "float32", "--preset", "train_gan_dfm",
                 "--residual_blocks", "1", "--batch_size", "2",
                 "--hr_height", "32", "--steps", "2", "--warmup_batches",
                 "1", "--eval_dir", str(setup["root"] / "hr"),
                 "--eval_interval", "1", "--log_dir", str(log)]) == 0
    with open(log / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    evals = [ln for ln in lines if ln["prefix"] == "eval"]
    assert [ln["step"] for ln in evals] == [1, 2]
    for ln in evals:
        assert ln["val_n_images"] == 3
        assert {"val_psnr_rgb", "val_psnr_y", "val_ssim"} <= set(ln)
        assert all(np.isfinite(ln[k]) for k in ln if k.startswith("val_"))
