"""The port's image metrics (``super_resolution_tpu_torch.metrics``)
against the JAX package's on the same seeded numpy images, HWC and NHWC,
within 1e-5 absolute; the JAX tests' properties of SSIM and the BT.601
luma; and ``MetricLogger.log_once``.

Both sides compute in float32 and sum in other orders, which moves a
PSNR of 10-40 dB and an SSIM by far less than 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu import metrics as jm
from super_resolution_tpu_torch.metrics import (
    MetricLogger,
    eval_metrics,
    psnr01,
    rgb_to_y,
    ssim,
)

ATOL = 1e-5
SHAPES = {"hwc": (40, 52, 3), "nhwc": (2, 32, 36, 3)}


def _pair(shape, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + noise * rng.standard_normal(shape).astype(np.float32),
                0.0, 1.0).astype(np.float32)
    return a, b


@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_metrics_match_jax(layout):
    a, b = _pair(SHAPES[layout], seed=len(layout))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(rgb_to_y(ta).numpy(),
                               np.asarray(jm.rgb_to_y(ja)), atol=ATOL)
    assert float(psnr01(ta, tb)) == pytest.approx(
        float(jm.psnr01(ja, jb)), abs=ATOL)
    assert float(ssim(ta, tb)) == pytest.approx(
        float(jm.ssim(ja, jb)), abs=ATOL)
    got, ref = eval_metrics(ta, tb), jm.eval_metrics(ja, jb)
    assert set(got) == set(ref) == {"psnr_rgb", "psnr_y", "ssim"}
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), abs=ATOL), k


def test_ssim_identity_is_one():
    x = torch.from_numpy(np.random.RandomState(0).rand(32, 32, 3)
                         .astype(np.float32))
    assert float(ssim(x, x)) == pytest.approx(1.0, abs=1e-5)


def test_ssim_decreases_with_noise():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.rand(48, 48, 3).astype(np.float32))
    small = x + 0.01 * torch.from_numpy(rng.randn(48, 48, 3)
                                        .astype(np.float32))
    big = x + 0.2 * torch.from_numpy(rng.randn(48, 48, 3).astype(np.float32))
    s_small, s_big = float(ssim(small, x)), float(ssim(big, x))
    assert 1.0 > s_small > s_big > 0.0


def test_ssim_matches_skimage_if_available():
    skimage = pytest.importorskip("skimage.metrics")
    rng = np.random.RandomState(2)
    a = rng.rand(64, 64).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(64, 64).astype(np.float32), 0, 1)
    ref = skimage.structural_similarity(
        a, b, gaussian_weights=True, sigma=1.5, use_sample_covariance=False,
        data_range=1.0)
    ours = float(ssim(torch.from_numpy(a)[..., None],
                      torch.from_numpy(b)[..., None]))
    assert ours == pytest.approx(ref, abs=5e-3)


def test_rgb_to_y_bt601_endpoints():
    assert float(rgb_to_y(torch.ones(1, 1, 3))[0, 0]) == pytest.approx(
        235 / 255, abs=1e-3)
    assert float(rgb_to_y(torch.zeros(1, 1, 3))[0, 0]) == pytest.approx(
        16 / 255, abs=1e-3)


def test_eval_metrics_identity():
    x = torch.from_numpy(np.random.RandomState(3).rand(16, 16, 3)
                         .astype(np.float32))
    assert float(eval_metrics(x, x)["psnr_rgb"]) > 60


def test_log_once_writes_one_jsonl_line(tmp_path, capsys):
    lg = MetricLogger(str(tmp_path))
    lg.update({"a": torch.tensor(1.0)})
    lg.update({"a": torch.tensor(3.0)})
    assert lg.flush(10, "train", extra={"thr": 5.0}) == {"a": 2.0,
                                                         "thr": 5.0}
    # non-numeric values are dropped; the accumulator is untouched
    lg.update({"b": torch.tensor(4.0)})
    lg.log_once(11, "eval", {"val_psnr": 30.0, "n_images": 2,
                             "note": "x"})
    assert lg.flush(12, "train") == {"b": 4.0}
    lg.close()
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0] == {"step": 10, "prefix": "train", "a": 2.0, "thr": 5.0}
    assert lines[1] == {"step": 11, "prefix": "eval", "val_psnr": 30.0,
                        "n_images": 2.0}
    assert "[eval step 11] n_images=2 val_psnr=30" in capsys.readouterr().out
