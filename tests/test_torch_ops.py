"""The port's small ops against the JAX package's: shuffles (NCHW in
the port, NHWC in JAX), PIL-parity bicubic resampling, self-ensemble,
normalisation and the uint8 round trip, the alpha plane, image listing
and the halo sidecar reader."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu import halo_sweep as jax_halo
from super_resolution_tpu.config import DataConfig as JaxDataConfig
from super_resolution_tpu.data import augment as jax_augment
from super_resolution_tpu.data import image_io as jax_image_io
from super_resolution_tpu.data.pipeline import list_images as jax_list
from super_resolution_tpu.ops import ensemble as jax_ensemble
from super_resolution_tpu.ops import resize as jax_resize
from super_resolution_tpu.ops import shuffle as jax_shuffle
from super_resolution_tpu_torch import halo_sweep
from super_resolution_tpu_torch.config import DataConfig
from super_resolution_tpu_torch.data import (
    list_images,
    normalize,
    to_uint8_image,
    upscale_alpha,
)
from super_resolution_tpu_torch.ops import (
    bicubic_resize,
    nearest_upsample,
    pixel_shuffle,
    self_ensemble,
)

RNG = np.random.default_rng(0)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_pixel_shuffle_matches_jax_and_torch():
    x = RNG.standard_normal((2, 5, 6, 12)).astype(np.float32)   # NHWC
    ref = np.asarray(jax_shuffle.pixel_shuffle(jnp.asarray(x), 2))
    got = pixel_shuffle(_nchw(x), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    assert torch.equal(got, torch.nn.functional.pixel_shuffle(_nchw(x), 2))


def test_nearest_upsample_matches_jax():
    x = RNG.standard_normal((1, 4, 7, 3)).astype(np.float32)
    ref = np.asarray(jax_shuffle.nearest_upsample(jnp.asarray(x), 2))
    got = nearest_upsample(_nchw(x), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,out", [((1, 9, 13, 2), (36, 52)),
                                       ((2, 40, 24, 3), (10, 6)),
                                       ((17, 5, 1), (68, 20))])
def test_bicubic_resize_matches_jax(shape, out):
    x = RNG.random(shape).astype(np.float32)
    ref = np.asarray(jax_resize.bicubic_resize(jnp.asarray(x), *out))
    got = bicubic_resize(torch.from_numpy(x), *out).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_self_ensemble_matches_jax():
    lr = RNG.standard_normal((6, 9, 3)).astype(np.float32)
    w = RNG.standard_normal((3, 3)).astype(np.float32)

    def jax_fn(x):   # position-dependent, so every transform matters
        y = jnp.repeat(jnp.repeat(x @ jnp.asarray(w), 2, 0), 2, 1)
        return y * jnp.arange(y.shape[1], dtype=jnp.float32)[None, :, None]

    def port_fn(x):
        y = (x @ torch.from_numpy(w)).repeat_interleave(2, 0) \
            .repeat_interleave(2, 1)
        return y * torch.arange(y.shape[1], dtype=torch.float32)[None, :,
                                                                  None]

    ref = np.asarray(jax_ensemble.self_ensemble(jax_fn, jnp.asarray(lr)))
    got = self_ensemble(port_fn, torch.from_numpy(lr)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_normalize_and_uint8_round_trip_match_jax():
    cfg, jcfg = DataConfig(), JaxDataConfig()
    x01 = RNG.random((7, 5, 3)).astype(np.float32)
    # values on the .5 boundary exercise round-half-to-even
    x01[0, :, :] = (np.arange(15).reshape(5, 3) + 0.5) / 255.0
    ref_n = np.asarray(jax_augment.normalize(
        jnp.asarray(x01), jcfg.normalize_mean, jcfg.normalize_std))
    got_n = normalize(torch.from_numpy(x01), cfg.normalize_mean,
                      cfg.normalize_std).numpy()
    np.testing.assert_array_equal(got_n, ref_n)
    wild = (RNG.standard_normal((7, 5, 3)) * 3).astype(np.float32)
    np.testing.assert_array_equal(
        to_uint8_image(torch.from_numpy(wild), cfg).numpy(),
        np.asarray(jax_augment.to_uint8_image(jnp.asarray(wild), jcfg)))


def test_upscale_alpha_matches_jax():
    alpha = RNG.integers(0, 256, (11, 14)).astype(np.uint8)
    ref = jax_image_io.upscale_alpha(alpha, 4)
    got = upscale_alpha(alpha, 4, "cpu")
    assert got.shape == ref.shape == (44, 56)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_list_images_matches_jax(tmp_path):
    (tmp_path / "sub").mkdir()
    for name in ("b.png", "a.JPG", "sub/c.webp", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert list_images(str(tmp_path)) == jax_list(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        list_images(str(tmp_path / "sub" / "missing"))


@pytest.mark.parametrize("meta", [None, {"admissible_halo": 5},
                                  {"admissible_halo": None}])
def test_halo_sidecar_read_matches_jax(tmp_path, meta):
    ck = str(tmp_path / "g.pth")
    if meta is not None:
        with open(halo_sweep.halo_meta_path(ck), "w") as f:
            json.dump(meta, f)
    assert halo_sweep.halo_meta_path(ck) == jax_halo.halo_meta_path(ck)
    assert halo_sweep.read_halo_meta(ck) == jax_halo.read_halo_meta(ck)
    assert halo_sweep.read_admissible_halo(ck) == \
        jax_halo.read_admissible_halo(ck)
