"""The port's ``conv_impl="lax"`` against the JAX package's, on the CPU:
the generator with the JAX weights carried across, and one pretrain
step, which differentiates through ``F.conv2d``; ``cli upscale
--conv_impl lax`` against the port's direct forward (0 uint8 delta), and
``cli train --conv_impl pallas``, which trains on lax.

Tolerances: float32 at tests/test_parity.py's (atol 2e-5, rtol 1e-4;
two frameworks' convolutions sum in another order).  bfloat16 against
the largest |y|: 2^-5 (about four bf16 ULPs).  Both packages round
every conv, LeakyReLU and residual to bf16, but XLA rounds a conv's
output and adds the bf16 bias after it, where PyTorch's conv adds the
bias before its one rounding, and the sums run in another order, so a
rounding flips here and there and the trunk carries it (measured 7.9e-3
and 5.0e-3 of the largest |y| at these shapes; float32 4.2e-7).  The
pretrain step is held as ``tests/test_torch_train_steps.py`` holds it.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import super_resolution_tpu.train.steps as jsteps
from super_resolution_tpu.config import GeneratorConfig as JaxGeneratorConfig
from super_resolution_tpu.models import RRDBNet as JaxRRDBNet
from super_resolution_tpu_torch import config as C
from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.data import normalize, to_uint8_image
from super_resolution_tpu_torch.import_torch import (
    import_generator,
    load_pth,
    state_dict_from_flax,
)
from super_resolution_tpu_torch.models.rrdb import RRDBNet
from super_resolution_tpu_torch.train.steps import (
    make_pretrain_step,
    training_cfg,
)

from torch_spec import RRDBNetTorch

import test_torch_train_steps as ts

CFGS = {"nearest": dict(n_blocks=2, filters=16, growth=8),
        "pixelshuffle": dict(n_blocks=2, filters=16, growth=8,
                             upsampler="pixelshuffle", lrelu_slope=0.01)}


def _pair(cfg_kw, dtype, seed):
    """(JAX output, port output) of the lax generator on one input."""
    x = np.random.default_rng(seed).standard_normal((2, 12, 20, 3)) \
        .astype(np.float32)
    # torch_default weights: outputs of order 1 that depend on the trunk
    # (msra_scaled gives outputs near 1e-4)
    jcfg = JaxGeneratorConfig(conv_impl="lax", init="torch_default",
                              **cfg_kw)
    params = JaxRRDBNet(jcfg).init(jax.random.key(seed),
                                   jnp.asarray(x[:1]))["params"]
    ref = JaxRRDBNet(jcfg, dtype=getattr(jnp, dtype)).apply(
        {"params": params}, jnp.asarray(x))
    model = RRDBNet(C.GeneratorConfig(conv_impl="lax", init="torch_default",
                                      **cfg_kw))
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, params)), strict=True)
    with torch.inference_mode():
        got = model.prepare(getattr(torch, dtype))(torch.from_numpy(x))
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_generator_matches_jax_lax_fp32(name):
    ref, got = _pair(CFGS[name], "float32", 1)
    assert got.shape == ref.shape == (2, 48, 80, 3)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_generator_matches_jax_lax_bf16(name):
    ref, got = _pair(CFGS[name], "bfloat16", 2)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2.0 ** -5 * np.abs(ref).max()


def test_pretrain_step_under_lax_matches_jax(monkeypatch):
    jcfg, pcfg = ts._cfgs(loss=dict(use_perceptual=False))
    pcfg = dataclasses.replace(pcfg, generator=dataclasses.replace(
        pcfg.generator, conv_impl="lax"))
    assert jcfg.generator.conv_impl == "lax"
    assert training_cfg(pcfg).generator.conv_impl == "lax"
    run = ts._JaxRun(monkeypatch)
    js = ts._j_state(jcfg)
    ps = ts._carry(js, pcfg)
    assert ps.g.impl == "lax"
    pair = ts._batch(0)
    js, jm, jgrads = run(jsteps.make_pretrain_step(jcfg, jit=False), js,
                         pair)
    pm = make_pretrain_step(pcfg).core(ps, *map(torch.from_numpy, pair))
    ts._compare_after(ps, pm, js, jm, jgrads, pcfg)


@pytest.mark.parametrize("impl", ["pallas", "pallas_fused"])
def test_training_cfg_trains_nhwc_impls_on_lax(impl, capsys):
    cfg = C.TrainConfig(generator=C.GeneratorConfig(conv_impl=impl))
    assert training_cfg(cfg).generator.conv_impl == "lax"
    assert "training on 'lax'" in capsys.readouterr().out
    # the JAX package does the same (its fallback for kernels without a
    # backward)
    jcfg = jsteps._training_cfg(dataclasses.replace(
        ts._cfgs()[0], generator=JaxGeneratorConfig(conv_impl=impl)))
    assert jcfg.generator.conv_impl == "lax"


def test_lax_launches_no_kernel_and_packs_nothing():
    model = RRDBNet(C.GeneratorConfig(conv_impl="lax", n_blocks=1,
                                      filters=16, growth=8))
    model.prepare(torch.float32)
    block = model.body[0].rdb1
    assert block._w is None and block.conv1._w is not None
    with torch.inference_mode():
        y = model(torch.zeros(1, 8, 8, 3))
    assert y.shape == (1, 32, 32, 3)


def test_cli_upscale_lax_equals_direct_forward(tmp_path):
    torch.manual_seed(0)
    pth = str(tmp_path / "gen.pth")
    torch.save(RRDBNetTorch(nf=16, nb=1, gc=8).state_dict(), pth)
    lr = np.random.default_rng(5).integers(0, 256, (20, 28, 3),
                                           dtype=np.uint8)
    src, out = str(tmp_path / "lr.png"), str(tmp_path / "sr.png")
    Image.fromarray(lr).save(src)
    assert main(["upscale", "--image", src, "--checkpoint", pth, "--out",
                 out, "--device", "cpu", "--dtype", "float32",
                 "--conv_impl", "lax"]) == 0
    sd, gcfg = import_generator(load_pth(pth))
    model = RRDBNet(dataclasses.replace(gcfg, conv_impl="lax"))
    model.load_state_dict(sd, strict=True)
    model.prepare(torch.float32)
    data = C.DataConfig()
    x = normalize(torch.from_numpy(lr).float() / 255.0,
                  data.normalize_mean, data.normalize_std)
    with torch.inference_mode():
        ref = to_uint8_image(model(x[None])[0], data).numpy()
    with Image.open(out) as im:
        assert np.array_equal(np.asarray(im), ref)


def test_cli_train_pallas_runs_on_lax(tmp_path, capsys):
    """One warmup and one GAN step of ``cli train --conv_impl pallas``:
    it says it trains on lax, and the checkpoint holds finite weights."""
    ck = tmp_path / "ck"
    assert main(["train", "--dataset_dir", "/nonexistent/synthetic",
                 "--checkpoint_dir", str(ck), "--device", "cpu", "--dtype",
                 "float32", "--preset", "train_gan_dfm",
                 "--residual_blocks", "1", "--batch_size", "2",
                 "--hr_height", "32", "--steps", "2", "--warmup_batches",
                 "1", "--conv_impl", "pallas"]) == 0
    assert "training on 'lax'" in capsys.readouterr().out
    state = torch.load(ck / "2" / "state.pt", weights_only=True)
    assert state["step"] == 2
    assert all(bool(torch.isfinite(v).all()) for v in state["g"].values())
