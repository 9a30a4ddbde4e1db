"""The port's clamped overlap-blend tiling against the JAX package's
``parallel/tiling.py``: the tile planner, the blend window, the height
bucket (with the port's flat rate knots on both sides), and
``tiled_upscale`` itself on the same model and geometry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.config import GeneratorConfig as JaxGeneratorConfig
from super_resolution_tpu.models import RRDBNet as JaxRRDBNet
from super_resolution_tpu.parallel import tiling as jax_tiling
from super_resolution_tpu_torch.config import GeneratorConfig
from super_resolution_tpu_torch.import_torch import state_dict_from_flax
from super_resolution_tpu_torch.models.rrdb import RRDBNet
from super_resolution_tpu_torch.parallel import tiling

CFG = dict(n_blocks=1, filters=16, growth=8)


@pytest.fixture(scope="module")
def models():
    """(jax apply fn, port forward) with the same float32 weights."""
    jm = JaxRRDBNet(JaxGeneratorConfig(conv_impl="lax", **CFG))
    params = jm.init(jax.random.key(0),
                     jnp.zeros((1, 8, 8, 3)))["params"]
    pm = RRDBNet(GeneratorConfig(**CFG))
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    pm.prepare(torch.float32)

    def port_fn(x):
        with torch.inference_mode():
            return pm(x)

    return jax.jit(lambda x: jm.apply({"params": params}, x)), port_fn


@pytest.mark.parametrize("h,w,tile,halo,tile_w", [
    (100, 60, 32, 4, None), (2048, 2048, 128, 8, None),
    (200, 300, 64, 4, 40), (100, 400, 512, 8, 48), (31, 17, 16, 2, 12),
])
def test_plan_tiles_matches_jax(h, w, tile, halo, tile_w):
    assert tiling.plan_tiles(h, w, tile, halo, tile_w) == \
        jax_tiling.plan_tiles(h, w, tile, halo, tile_w)


@pytest.mark.parametrize("tile,halo,scale,tile_w", [
    (32, 4, 4, None), (48, 8, 4, 40), (20, 0, 2, None)])
def test_blend_window_matches_jax(tile, halo, scale, tile_w):
    np.testing.assert_array_equal(
        tiling.blend_window(tile, halo, scale, tile_w),
        jax_tiling.blend_window(tile, halo, scale, tile_w))


def test_bucket_tile_h_matches_jax_with_flat_knots(monkeypatch):
    assert all(r == 1.0 for _, r in tiling._HEIGHT_RATE_KNOTS)
    monkeypatch.setattr(jax_tiling, "_HEIGHT_RATE_KNOTS",
                        tiling._HEIGHT_RATE_KNOTS)
    for h in (100, 720, 1080, 1440, 2048, 4000):
        for tile_h, halo, bucket in ((4096, 4, 64), (4096, 8, 64),
                                     (512, 8, 32), (64, 40, 64)):
            assert tiling.bucket_tile_h(h, tile_h, halo, bucket) == \
                jax_tiling.bucket_tile_h(h, tile_h, halo, bucket), \
                (h, tile_h, halo, bucket)


@pytest.mark.parametrize("kw", [
    dict(tile=32, halo=6, tile_batch=3),
    dict(tile=48, halo=8, tile_w=24, tile_batch=2),
    dict(tile=64, halo=4, bucket_h=16, tile_batch=4),
    dict(tile=40, halo=4, align=(8, 16), tile_batch=8),
], ids=["square", "rect", "bucket", "align"])
def test_tiled_upscale_matches_jax(models, kw):
    jax_fn, port_fn = models
    rng = np.random.default_rng(1)
    lr = rng.standard_normal((50, 70, 3)).astype(np.float32)
    ref = np.asarray(jax_tiling.tiled_upscale(jax_fn, jnp.asarray(lr),
                                              scale=4, **kw))
    got = tiling.tiled_upscale(port_fn, torch.from_numpy(lr), scale=4,
                               **kw).numpy()
    assert got.shape == ref.shape == (200, 280, 3)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def test_tiled_matches_whole_frame_within_the_port(models):
    """A wide halo makes the blend indistinguishable from whole-frame
    inference; the frame borders are exact by construction (clamped
    tiles, never padded)."""
    _, port_fn = models
    rng = np.random.default_rng(2)
    lr = torch.from_numpy(rng.standard_normal((60, 52, 3))
                          .astype(np.float32))
    whole = port_fn(lr[None])[0].numpy()
    tiled = tiling.tiled_upscale(port_fn, lr, scale=4, tile=36, halo=10,
                                 tile_batch=2).numpy()
    np.testing.assert_allclose(tiled, whole, atol=5e-4)
    np.testing.assert_allclose(tiled[:8], whole[:8], atol=5e-4)
    np.testing.assert_allclose(tiled[:, -8:], whole[:, -8:], atol=5e-4)


def test_single_tile_frame_runs_whole(models):
    _, port_fn = models
    lr = torch.from_numpy(np.random.default_rng(3)
                          .standard_normal((20, 24, 3)).astype(np.float32))
    np.testing.assert_array_equal(
        tiling.tiled_upscale(port_fn, lr, tile=32, halo=4).numpy(),
        port_fn(lr[None])[0].numpy())
