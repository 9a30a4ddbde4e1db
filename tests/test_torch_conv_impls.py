"""The port's three further conv paths (``conv_impl`` ``pallas_cf_tail``,
``pallas`` and ``pallas_fused``) against the JAX package's, on the CPU:

- the generator against ``RRDBNet(conv_impl=impl)`` of the JAX package,
  its Pallas kernels in interpret mode, float32 at atol 5e-5, rtol 1e-4
  (``tests/test_pallas.py``'s tolerance for the impls against lax).  The
  16×16 LR input keeps every tail plane inside the JAX band picker, so
  the JAX side runs its single-conv kernel there;
- the weights carried across from the JAX parameters, the same under
  every impl;
- one pretrain step under ``pallas_cf_tail`` (dense blocks and tail
  convs through the training entries) against the JAX step at that
  geometry, which the JAX package runs on lax (its kernels train only
  at 128-aligned or foldable widths), float32;
- ``cli upscale --conv_impl X`` against the port's direct forward under
  X: 0 uint8 delta;
- training: ``pallas`` and ``pallas_fused`` train on ``lax``, as in the
  JAX package, and say so; the initial weights do not depend on the
  impl.

The TPU interpreter dispatches JAX work from its callbacks, and eager
work that the test's thread dispatches meanwhile can deadlock it (flax's
``init`` creating parameters between interpreted kernels does).  So the
JAX parameters are initialised on lax, as the JAX package's own
``init_state`` does, and the trees of the other impls are compared by
``jax.eval_shape``, which runs no kernel; a forward through interpreted
kernels runs as one jitted call, except under ``pallas_cf_tail``, whose
dense blocks go through ``custom_partitioning``, which cannot lower the
interpreter's ordered callbacks: that one runs eagerly, as
``tests/test_pallas.py`` runs ``pallas_cf``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

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
from super_resolution_tpu_torch.train.state import init_state
from super_resolution_tpu_torch.train.steps import (
    make_pretrain_step,
    training_cfg,
)
from torch_spec import RRDBNetTorch

import test_torch_train_steps as ts

IMPLS = ("pallas_cf_tail", "pallas", "pallas_fused")
SMALL = dict(n_blocks=1, filters=16, growth=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(x, upsampler="nearest_conv"):
    cfg = JaxGeneratorConfig(conv_impl="lax", upsampler=upsampler, **SMALL)
    return _np(JaxRRDBNet(cfg).init(jax.random.key(4), x)["params"])


def _jax_param_shapes(impl, x):
    """The JAX parameter tree under ``impl``, traced only."""
    model = JaxRRDBNet(JaxGeneratorConfig(conv_impl=impl, **SMALL))
    tree = jax.eval_shape(lambda: model.init(jax.random.key(4), x))
    return jax.tree.map(lambda a: (a.shape, a.dtype), tree["params"])


@pytest.mark.parametrize("impl,upsampler", [
    ("pallas_cf_tail", "nearest_conv"), ("pallas_cf_tail", "pixelshuffle"),
    ("pallas", "nearest_conv"), ("pallas_fused", "nearest_conv")])
def test_generator_matches_jax_impl(impl, upsampler):
    x = np.random.default_rng(3).standard_normal((1, 16, 16, 3)) \
        .astype(np.float32)
    params = _jax_params(x, upsampler)
    jcfg = JaxGeneratorConfig(conv_impl=impl, upsampler=upsampler, **SMALL)
    apply = JaxRRDBNet(jcfg).apply
    if impl != "pallas_cf_tail":
        apply = jax.jit(apply)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(apply({"params": params}, jnp.asarray(x)))
    model = RRDBNet(C.GeneratorConfig(conv_impl=impl, upsampler=upsampler,
                                      **SMALL))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = model.prepare(torch.float32)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


def test_weights_carry_across_the_same_under_every_impl():
    """The JAX parameter tree (names, shapes, dtypes) is the same under
    every conv_impl, so the port's state dict carried from it is too; it
    loads strictly into the port's model under every impl, whose own
    state dict has the same names and shapes."""
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    want = _jax_param_shapes("lax", x)
    sd = state_dict_from_flax(_jax_params(np.zeros((1, 16, 16, 3),
                                                   np.float32)))
    for impl in IMPLS:
        assert _jax_param_shapes(impl, x) == want, impl
        model = RRDBNet(C.GeneratorConfig(conv_impl=impl, **SMALL))
        model.load_state_dict(sd, strict=True)
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
            == {k: tuple(v.shape) for k, v in sd.items()}


def test_pretrain_step_under_pallas_cf_tail_matches_jax(monkeypatch):
    jcfg, pcfg = ts._cfgs(loss=dict(use_perceptual=False))
    jcfg, pcfg = (dataclasses.replace(c, generator=dataclasses.replace(
        c.generator, conv_impl="pallas_cf_tail")) for c in (jcfg, pcfg))
    assert jsteps._training_cfg(jcfg).generator.conv_impl == "lax"
    assert training_cfg(pcfg).generator.conv_impl == "pallas_cf_tail"
    run = ts._JaxRun(monkeypatch)
    js = ts._j_state(jcfg)
    ps = ts._carry(js, pcfg)
    assert ps.g.impl == "pallas_cf_tail"
    pair = ts._batch(0)
    js, jm, jgrads = run(jsteps.make_pretrain_step(jcfg, jit=False), js,
                         pair)
    pm = make_pretrain_step(pcfg).core(ps, *map(torch.from_numpy, pair))
    ts._compare_after(ps, pm, js, jm, jgrads, pcfg)


@pytest.fixture
def pth(tmp_path):
    torch.manual_seed(0)
    path = str(tmp_path / "gen.pth")
    torch.save(RRDBNetTorch(nf=16, nb=1, gc=8).state_dict(), path)
    return path


@pytest.mark.parametrize("impl", IMPLS)
def test_cli_upscale_equals_direct_forward(impl, pth, tmp_path):
    rng = np.random.default_rng(5)
    lr = rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)
    src, out = str(tmp_path / "lr.png"), str(tmp_path / "sr.png")
    Image.fromarray(lr).save(src)
    assert main(["upscale", "--image", src, "--checkpoint", pth, "--out",
                 out, "--device", "cpu", "--dtype", "float32",
                 "--conv_impl", impl]) == 0
    sd, gcfg = import_generator(load_pth(pth))
    model = RRDBNet(dataclasses.replace(gcfg, conv_impl=impl))
    model.load_state_dict(sd, strict=True)
    model.prepare(torch.float32)
    data = C.DataConfig()
    x = normalize(torch.from_numpy(lr).float() / 255.0,
                  data.normalize_mean, data.normalize_std)
    with torch.inference_mode():
        ref = to_uint8_image(model(x[None])[0], data).numpy()
    with Image.open(out) as im:
        got = np.asarray(im)
    assert got.shape == ref.shape == (80, 112, 3)
    assert np.array_equal(got, ref)


def test_training_runs_nhwc_impls_on_pallas_cf(capsys):
    """The NHWC impls train on ``lax`` (the test keeps its name from when
    the port, without ``lax``, trained them on ``pallas_cf``)."""
    base = C.TrainConfig(generator=C.GeneratorConfig(**SMALL))
    for impl, want in (("auto", "pallas_cf"), ("pallas_cf", "pallas_cf"),
                       ("pallas_cf_tail", "pallas_cf_tail"),
                       ("lax", "lax"), ("pallas", "lax"),
                       ("pallas_fused", "lax")):
        cfg = dataclasses.replace(base, generator=dataclasses.replace(
            base.generator, conv_impl=impl))
        capsys.readouterr()
        assert training_cfg(cfg).generator.conv_impl == want
        said = capsys.readouterr().out
        assert ("has no backward" in said) == (impl in ("pallas",
                                                        "pallas_fused"))
    with pytest.raises(NotImplementedError, match="training_cfg"):
        RRDBNet(C.GeneratorConfig(conv_impl="pallas", **SMALL)) \
            .prepare(torch.float32, live=True)


def test_initial_weights_do_not_depend_on_the_impl():
    states = {impl: init_state(dataclasses.replace(
        ts._cfgs(loss=dict(use_perceptual=False))[1],
        generator=C.GeneratorConfig(conv_impl=impl, **SMALL)), "cpu")
        for impl in ("auto", "pallas_cf_tail")}
    a, b = (s.g.state_dict() for s in states.values())
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for impl in ("pallas", "pallas_fused"):
        g = RRDBNet(C.GeneratorConfig(conv_impl=impl, **SMALL),
                    torch.Generator().manual_seed(0)).state_dict()
        ref = RRDBNet(C.GeneratorConfig(**SMALL),
                      torch.Generator().manual_seed(0)).state_dict()
        assert all(torch.equal(g[k], ref[k]) for k in ref)
