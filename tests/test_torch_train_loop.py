"""The port's training loop through ``cli train --device cpu``: the
warmup -> GAN switch, non-square patches, step-exact resume, warm start
from a ``.pth``, the checkpoint in ``cli upscale``, and the flags that
raise: ``--loader grain`` without the grain package, ``--multihost`` without its
coordinator, data parallelism over more cards than there are.

Sizes: one RRDB (the CLI has no flag for the generator's width, so the
dense blocks run at the canonical 64 / 32 through their plain versions),
HR patches 32 x 32 (LR 8 x 8), batch 2, float32, the VGG-free
``train_gan_dfm`` preset.  Within the port the contracts are exact: a
resumed run reaches bit-identical parameters, since each batch is a
function of (seed, step) and the checkpoint carries both optimizers, D's
statistics, the EMA and the augmentation generator.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from super_resolution_tpu_torch.checkpoint import (
    latest_step,
    read_ema_provenance,
    restore_generator_params,
    restore_generator_trees,
)
from super_resolution_tpu_torch.cli import main
from torch_spec import RRDBNetTorch

SMALL = ["--device", "cpu", "--dtype", "float32", "--preset",
         "train_gan_dfm", "--residual_blocks", "1", "--batch_size", "2",
         "--hr_height", "32", "--seed", "3"]


def _train(ckpt, *extra, dataset="/nonexistent/synthetic"):
    assert main(["train", "--dataset_dir", str(dataset), "--checkpoint_dir",
                 str(ckpt), *SMALL, *extra]) == 0


def _state(ckpt, step=None):
    step = latest_step(str(ckpt)) if step is None else step
    return torch.load(os.path.join(str(ckpt), str(step), "state.pt"),
                      map_location="cpu", weights_only=True)


def _flat(tree, prefix=""):
    """Every tensor of a state tree, by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def run5(tmp_path_factory):
    """Five steps on synthetic patches with the warmup switch at 2."""
    root = tmp_path_factory.mktemp("run5")
    _train(root / "ck", "--steps", "5", "--warmup_batches", "2",
           "--log_dir", str(root / "log"), "--sample_dir", str(root / "s"),
           "--sample_interval", "5")
    return root


def test_five_steps_across_the_warmup_switch(run5):
    tree = _state(run5 / "ck")
    assert latest_step(str(run5 / "ck")) == 5 and tree["step"] == 5
    # G was updated in all five steps, D only in the three GAN steps
    assert tree["g_opt"]["param_groups"][0]["n_updates"] == 5
    assert tree["d_opt"]["param_groups"][0]["n_updates"] == 3
    with open(run5 / "log" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1 and lines[0]["step"] == 5
    assert lines[0]["prefix"] == "gan"
    for name in ("loss_pixel", "psnr", "grad_norm_g", "loss_adv", "loss_g",
                 "loss_percep", "loss_d", "grad_norm_d",
                 "mp_per_sec_per_chip"):
        assert np.isfinite(lines[0][name]), name
    # the EMA trails the parameters, and D's statistics have moved
    assert any(not torch.equal(tree["g_ema"][k], tree["g"][k])
               for k in tree["g"])
    assert float(tree["d"]["bn0_1.running_mean"].abs().max()) > 0
    with Image.open(run5 / "s" / "step00000005.png") as im:
        assert im.size == (2 * 32, 3 * 32)     # 2 samples x (bic, SR, HR)


def test_checkpoint_upscales_through_the_cli(run5, tmp_path):
    rng = np.random.default_rng(0)
    src, dst = str(tmp_path / "lr.png"), str(tmp_path / "sr.png")
    Image.fromarray(rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)) \
        .save(src)
    assert main(["upscale", "--image", src, "--checkpoint",
                 str(run5 / "ck"), "--out", dst, "--device", "cpu",
                 "--dtype", "float32"]) == 0
    with Image.open(dst) as im:
        assert im.size == (80, 48)
    # five steps are inside the EMA's maturity horizon and the run was
    # not warm-started: inference reads the raw parameters
    sd, step = restore_generator_params(str(run5 / "ck"), ema_decay=0.999)
    g, ema, _ = restore_generator_trees(str(run5 / "ck"))
    assert step == 5
    assert all(torch.equal(sd[k], g[k]) for k in g)


def test_non_square_patches_train(tmp_path):
    """--hr_width 24: LR patches 8 x 6, D's map 2 x 2."""
    _train(tmp_path / "ck", "--steps", "3", "--warmup_batches", "1",
           "--hr_width", "24")
    tree = _state(tmp_path / "ck")
    assert tree["step"] == 3
    assert all(bool(torch.isfinite(v).all())
               for v in _flat(tree).values() if v.is_floating_point())


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(1)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (48 + 4 * i, 56, 3),
                                     dtype=np.uint8)) \
            .save(root / f"{i}.png")
    return root


def test_resume_is_step_exact(image_dir, tmp_path):
    """3 steps, then --resume to 5, against 5 uninterrupted steps: the
    same batches from the threaded loader (which prefetches ahead of the
    loop), the same augmentation draws, bit-identical state."""
    common = ["--warmup_batches", "2", "--n_cpu", "2"]
    _train(tmp_path / "whole", "--steps", "5", *common, dataset=image_dir)
    _train(tmp_path / "parts", "--steps", "3", *common, dataset=image_dir)
    with open(tmp_path / "parts" / "3" / "data.json") as f:
        assert json.load(f) == {"seed": 3, "step": 3}
    _train(tmp_path / "parts", "--steps", "5", "--resume", *common,
           dataset=image_dir)
    assert latest_step(str(tmp_path / "parts")) == 5
    whole, parts = _flat(_state(tmp_path / "whole")), \
        _flat(_state(tmp_path / "parts"))
    assert sorted(whole) == sorted(parts)
    for name, want in whole.items():
        assert torch.equal(parts[name], want), name
    # and the steps did move the parameters after the resume point
    at3 = _flat(_state(tmp_path / "parts", 3))
    assert not torch.equal(at3["g.conv_first.weight"],
                           whole["g.conv_first.weight"])


def test_warm_start_seeds_the_ema_and_writes_provenance(tmp_path):
    torch.manual_seed(0)
    pth = str(tmp_path / "psnr.pth")
    sd0 = RRDBNetTorch(nf=64, nb=1, gc=32).state_dict()
    torch.save(sd0, pth)
    ck = tmp_path / "ck"
    _train(ck, "--steps", "1", "--warmup_batches", "0", "--init_g_from", pth)
    prov = read_ema_provenance(str(ck))
    assert prov == {"warm_start": True, "source": os.path.abspath(pth)}
    tree = _state(ck)
    # one update at decay 0.999 from an EMA seeded with the .pth weights
    for name in ("conv_first.weight", "body.0.rdb1.conv3.weight",
                 "conv_last.bias"):
        want = 0.999 * sd0[name] + 0.001 * tree["g"][name]
        torch.testing.assert_close(tree["g_ema"][name], want, atol=1e-7,
                                   rtol=1e-6)
        assert not torch.equal(tree["g"][name], sd0[name])
    # with the provenance the maturity gate lets the one-step EMA through
    sd, _ = restore_generator_params(str(ck), ema_decay=0.999)
    assert all(torch.equal(sd[k], tree["g_ema"][k]) for k in sd)
    # --resume keeps trusting it (the provenance is read back), and a
    # resume needs no --init_g_from
    _train(ck, "--steps", "2", "--warmup_batches", "0", "--resume")
    assert latest_step(str(ck)) == 2


@pytest.mark.parametrize("flags,err,match", [
    (["--multihost"], SystemExit, "--coordinator"),
    (["--loader", "grain"], ImportError, "'grain' package"),
    (["--data_parallel", "2", "--device", "cuda"],
     (RuntimeError, ValueError), "CUDA device"),
    (["--preset", "train_gan_dp8", "--device", "cuda"],
     (RuntimeError, ValueError), "CUDA device"),
], ids=["--multihost", "--loader grain", "--data_parallel 2",
        "--preset train_gan_dp8"])
def test_flags_not_ported_yet_raise(flags, err, match, tmp_path,
                                    monkeypatch):
    """What raises: the grain loader without the grain package (never
    the threaded loader in its place), --multihost without its
    coordinator flags, and more ranks than the machine has cards (never
    two to a card, never the CPU in their place)."""
    if torch.cuda.device_count() >= 8:
        pytest.skip("this machine has eight cards")
    monkeypatch.setitem(sys.modules, "grain", None)
    with pytest.raises(err, match=match):
        main(["train", "--dataset_dir", "/nonexistent/synthetic",
              "--checkpoint_dir", str(tmp_path / "ck"), "--device", "cpu",
              "--steps", "1", *flags])
    assert not os.path.exists(tmp_path / "ck")


def test_cuda_is_the_default_device_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--dataset_dir", "/nonexistent/synthetic",
              "--checkpoint_dir", str(tmp_path / "ck"), "--steps", "1"])
