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


@pytest.mark.parametrize("n_tiles_h,tile_batch", [(5, 2), (3, 4)])
def test_tiled_upscale_over_two_devices_equals_one(models, n_tiles_h,
                                                   tile_batch):
    """The tiles split over two replicas (two CPU "devices" here) give
    the one device's frame bit for bit: each replica runs the batches
    the single device would run, the last group unpadded."""
    _, port_fn = models
    lr = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16 * n_tiles_h - 8, 40, 3)).astype(np.float32))
    calls = []

    def replica(i):
        def fn(x):
            calls.append((i, x.shape[0]))
            return port_fn(x)
        return fn

    one = tiling.tiled_upscale(port_fn, lr, tile=16, halo=4,
                               tile_batch=tile_batch)
    two = tiling.tiled_upscale([replica(0), replica(1)], lr, tile=16,
                               halo=4, tile_batch=tile_batch,
                               devices=["cpu", "cpu"])
    assert torch.equal(one, two)
    n_tiles = len(tiling.plan_tiles(lr.shape[0], 40, 16, 4)[1]) * \
        len(tiling.plan_tiles(lr.shape[0], 40, 16, 4)[2])
    assert sum(n for _, n in calls) == n_tiles
    assert {i for i, _ in calls} == {0, 1}
    assert all(n <= tile_batch for _, n in calls)


def test_cli_upscale_over_two_devices_equals_one(tmp_path):
    """``cli upscale --data_parallel 2`` (two CPU replicas) writes the
    one-device frame's bytes; on a machine with fewer than two cards
    ``--device cuda`` raises instead of running elsewhere."""
    from PIL import Image

    from super_resolution_tpu_torch.cli import main
    from torch_spec import RRDBNetTorch

    torch.manual_seed(0)
    pth = str(tmp_path / "g.pth")
    torch.save(RRDBNetTorch(nf=16, nb=1, gc=8).state_dict(), pth)
    src = str(tmp_path / "lr.png")
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (40, 36, 3), dtype=np.uint8)).save(src)
    out = {}
    for n in ("1", "2"):
        out[n] = str(tmp_path / f"sr{n}.png")
        assert main(["upscale", "--image", src, "--checkpoint", pth,
                     "--out", out[n], "--device", "cpu", "--dtype",
                     "float32", "--tile", "16", "--halo", "4",
                     "--tile_batch", "2", "--data_parallel", n]) == 0
    with Image.open(out["1"]) as a, Image.open(out["2"]) as b:
        assert np.array_equal(np.asarray(a), np.asarray(b))
    if torch.cuda.device_count() < 2:
        with pytest.raises((RuntimeError, ValueError), match="CUDA device"):
            main(["upscale", "--image", src, "--checkpoint", pth, "--out",
                  str(tmp_path / "x.png"), "--data_parallel", "2",
                  "--device", "cuda"])
        assert not (tmp_path / "x.png").exists()
