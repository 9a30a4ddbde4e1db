"""The port's RRDBNet against the JAX package's ``RRDBNet(conv_impl="lax")``
in float32, with the JAX init carried across by
``import_torch.state_dict_from_flax``, and the port's ``.pth`` import
against the JAX package's.

Tolerances are those of tests/test_parity.py: atol 2e-5, rtol 1e-4
(two frameworks' float32 convolutions sum in another order).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu import import_torch as jax_import
from super_resolution_tpu.config import GeneratorConfig as JaxGeneratorConfig
from super_resolution_tpu.config import preset as jax_preset
from super_resolution_tpu.models import RRDBNet as JaxRRDBNet
from super_resolution_tpu_torch import import_torch as port_import
from super_resolution_tpu_torch.config import (
    DataConfig,
    GeneratorConfig,
    preset,
)
from super_resolution_tpu_torch.models.rrdb import RRDBNet
from torch_spec import RRDBNetTorch


def _jax_model(cfg_kw, seed, x):
    cfg = JaxGeneratorConfig(conv_impl="lax", **cfg_kw)
    model = JaxRRDBNet(cfg)
    params = model.init(jax.random.key(seed), jnp.asarray(x[:1]))["params"]
    return model, params


def _port_model(cfg_kw, state_dict):
    model = RRDBNet(GeneratorConfig(**cfg_kw))
    model.load_state_dict(state_dict, strict=True)
    return model.prepare(torch.float32)


@pytest.mark.parametrize("cfg_kw", [
    dict(n_blocks=2, filters=16, growth=8),
    dict(n_blocks=2, filters=16, growth=8, upsampler="pixelshuffle"),
    dict(n_blocks=2, filters=16, growth=16, upsampler="pixelshuffle",
         lrelu_slope=0.01),
    dict(n_blocks=1),                       # canonical widths 64 / 32
], ids=["nearest", "pixelshuffle", "erik_slope001", "canonical_nb1"])
def test_generator_matches_jax_lax(cfg_kw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 20, 3)).astype(np.float32)
    jm, params = _jax_model(cfg_kw, 1, x)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = _port_model(cfg_kw, port_import.state_dict_from_flax(params))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 48, 80, 3)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def test_state_dict_from_flax_matches_export_generator():
    cfg_kw = dict(n_blocks=2, filters=16, growth=8)
    x = np.zeros((1, 8, 8, 3), np.float32)
    _, params = _jax_model(cfg_kw, 2, x)
    ref = jax_import.export_generator(params, JaxGeneratorConfig(**cfg_kw))
    got = port_import.state_dict_from_flax(params)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the port's module names are exactly these keys
    assert sorted(RRDBNet(GeneratorConfig(**cfg_kw)).state_dict()) \
        == sorted(ref)


def _rename(sd, style, n_blocks):
    """A BasicSR-named state dict in another naming family."""
    inv = {v: k for k, v in
           port_import.generator_key_map(style, n_blocks).items()}
    return {f"{inv[k.rsplit('.', 1)[0]]}.{k.rsplit('.', 1)[1]}": v
            for k, v in sd.items()}


@pytest.mark.parametrize("style", port_import.STYLES)
def test_import_generator_families_match_jax(style):
    slope = 0.01 if style == "erik" else 0.2
    torch.manual_seed(3)
    tm = RRDBNetTorch(nf=16, nb=2, gc=8, slope=slope)
    sd = _rename(tm.state_dict(), style, 2)
    got, cfg = port_import.import_generator(sd)
    variables, jcfg = jax_import.import_generator(sd)
    want = dataclasses.asdict(jcfg)
    want["conv_impl"] = "auto"
    assert dataclasses.asdict(cfg) == want
    assert cfg.lrelu_slope == slope
    # same tensors as the JAX import, OIHW
    ref = jax_import.export_generator(variables["params"], jcfg)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    # and a strict load into the port's model reproduces the spec model
    model = RRDBNet(cfg)
    model.load_state_dict(got, strict=True)
    model.prepare(torch.float32)
    x = torch.randn(1, 3, 10, 12)
    with torch.inference_mode():
        out = model(x.permute(0, 2, 3, 1))
        spec = tm(x).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), spec.numpy(), atol=2e-5,
                               rtol=1e-4)


def test_import_rejects_unmapped_keys_unless_lenient():
    sd = RRDBNetTorch(nf=16, nb=1, gc=8).state_dict()
    sd["step"] = torch.tensor(3)
    with pytest.raises(ValueError, match="unmapped"):
        port_import.import_generator(sd)
    got, _ = port_import.import_generator(sd, strict=False)
    assert "step" not in got


@pytest.mark.parametrize("wrapper", ["params_ema", "params", "state_dict",
                                     None])
def test_load_pth_unwraps_and_casts_like_jax(wrapper, tmp_path):
    torch.manual_seed(4)
    sd = {k: v.half() for k, v in
          RRDBNetTorch(nf=16, nb=1, gc=8).state_dict().items()}
    blob = sd if wrapper is None else {wrapper: sd, "iter": 7}
    if wrapper == "params_ema":             # preferred over params
        blob["params"] = {k: torch.zeros_like(v) for k, v in sd.items()}
    path = str(tmp_path / "g.pth")
    torch.save(blob, path)
    got = port_import.load_pth(path)
    ref = jax_import.load_pth(path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), ref[k])


def test_configs_match_jax_field_for_field():
    port = dataclasses.asdict(GeneratorConfig())
    jax_cfg = dataclasses.asdict(JaxGeneratorConfig())
    assert port == jax_cfg
    assert dataclasses.asdict(DataConfig()) == dataclasses.asdict(
        jax_preset("infer_single").data)
    for name in ("infer_single", "infer_tiled"):
        assert preset(name).compute_dtype == jax_preset(name).compute_dtype
        assert dataclasses.asdict(preset(name).generator) == \
            dataclasses.asdict(jax_preset(name).generator)


def test_only_auto_conv_impl_and_naive_tail():
    """Every conv path of the JAX package builds, lax included; an
    unknown impl raises, and the polyphase tail is not ported yet and
    raises."""
    with pytest.raises(ValueError, match="conv_impl"):
        GeneratorConfig(conv_impl="xla")
    with pytest.raises(NotImplementedError):
        RRDBNet(GeneratorConfig(n_blocks=1, filters=16, growth=8,
                                tail_up="polyphase"))
    for impl in ("auto", "lax", "pallas_cf", "pallas_cf_tail", "pallas",
                 "pallas_fused"):
        model = RRDBNet(GeneratorConfig(n_blocks=1, filters=16, growth=8,
                                        conv_impl=impl))
        assert model.impl == ("pallas_cf" if impl == "auto" else impl)


def test_forward_before_prepare_raises():
    model = RRDBNet(GeneratorConfig(n_blocks=1, filters=16, growth=8))
    with pytest.raises(RuntimeError, match="prepare"):
        model(torch.zeros(1, 8, 8, 3))


@functools.lru_cache(maxsize=1)
def _four_conv_reference():
    """The JAX lax RRDBNet with 4 convs per dense block, 8 filters and
    growth 4, its params as the port's state dict, an input and its
    output."""
    cfg_kw = dict(n_blocks=1, filters=8, growth=4, n_dense_convs=4)
    x = np.random.default_rng(5).standard_normal((1, 10, 12, 3)) \
        .astype(np.float32)
    jm, params = _jax_model(cfg_kw, 6, x)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    return cfg_kw, port_import.state_dict_from_flax(params), x, ref


@pytest.mark.parametrize("impl", ["auto", "lax", "pallas_cf",
                                  "pallas_cf_tail", "pallas", "pallas_fused"])
def test_any_dense_conv_count_matches_jax_lax(impl):
    """``n_dense_convs=4, growth=4``: the port builds conv1..conv4 per
    dense block, loads the JAX model's weights with strict=True and
    matches it under every conv impl on the CPU."""
    cfg_kw, sd, x, ref = _four_conv_reference()
    model = RRDBNet(GeneratorConfig(conv_impl=impl, **cfg_kw))
    assert not hasattr(model.body[0].rdb1, "conv5")
    model.load_state_dict(sd, strict=True)
    model.prepare(torch.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 40, 48, 3)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
