"""The port's device-side preprocessing and its loaders against the JAX
package's: ``bicubic_downsample``, ``preprocess_batch`` without
augmentation, ``augment_batch`` with the flip/rot decisions injected
(``jax.random`` and ``torch.Generator`` draw other bits from one seed),
``SyntheticPatches`` byte for byte, and ``PatchLoader`` resume.

Tolerance 2e-6 for the bicubic paths (float32 matmuls summed in another
order); the flips and the uint8 streams are exact.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import super_resolution_tpu.data.augment as JA
from super_resolution_tpu.config import DataConfig as JDataConfig
from super_resolution_tpu.data import PatchLoader as JPatchLoader
from super_resolution_tpu.data import SyntheticPatches as JSynthetic
from super_resolution_tpu.ops.resize import bicubic_downsample as j_down
from super_resolution_tpu_torch.config import DataConfig
from super_resolution_tpu_torch.data import (
    PatchLoader,
    SyntheticPatches,
    device_prefetch,
    pair_images,
)
from super_resolution_tpu_torch.data.augment import (
    augment_batch,
    draw_decisions,
    preprocess_batch,
)
from super_resolution_tpu_torch.ops.resize import bicubic_downsample

TOL = dict(atol=2e-6, rtol=2e-6)


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 48, 24, 3)])
def test_bicubic_downsample(shape):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    np.testing.assert_allclose(
        bicubic_downsample(torch.from_numpy(x), 4).numpy(),
        np.asarray(j_down(jnp.asarray(x), 4)), **TOL)
    with pytest.raises(ValueError):
        bicubic_downsample(torch.zeros(1, 30, 32, 3), 4)


@pytest.mark.parametrize("hw", [(32, 32), (32, 24)])
def test_preprocess_batch_without_augmentation(hw):
    cfg = dict(hr_patch=hw[0], hr_patch_w=hw[1], batch_size=2)
    batch = _u8(1, (2, *hw, 3))
    want = JA.preprocess_batch(jax.random.key(0), jnp.asarray(batch),
                               JDataConfig(**cfg), augment=False)
    got = preprocess_batch(torch.from_numpy(batch), DataConfig(**cfg),
                           augment=False)
    assert got["lr"].shape == (2, hw[0] // 4, hw[1] // 4, 3)
    for k in ("lr", "hr"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)


def test_preprocess_paired_batch():
    cfg = dict(hr_patch=32, batch_size=2)
    batch = {"hr": _u8(2, (2, 32, 32, 3)), "lr": _u8(3, (2, 8, 8, 3))}
    want = JA.preprocess_batch(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()},
        JDataConfig(**cfg), augment=False)
    got = preprocess_batch({k: torch.from_numpy(v)
                            for k, v in batch.items()}, DataConfig(**cfg),
                           augment=False)
    for k in ("lr", "hr"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)
    # augmented: both resolutions get the same decisions
    dec = (torch.tensor([True, False]), torch.tensor([False, True]),
           torch.tensor([True, True]))
    aug = preprocess_batch({k: torch.from_numpy(v)
                            for k, v in batch.items()}, DataConfig(**cfg),
                           augment=True, decisions=dec)
    for k in ("lr", "hr"):
        np.testing.assert_array_equal(
            aug[k].numpy(), augment_batch(got[k], dec).numpy())


@pytest.mark.parametrize("shape", [(4, 16, 16, 3), (4, 16, 8, 3)])
def test_augment_batch_with_injected_decisions(shape, monkeypatch):
    """Both sides apply the same per-sample hflip / vflip / transpose:
    the JAX side's Bernoulli draws are replaced by the injected ones."""
    x = np.random.default_rng(4).random(shape).astype(np.float32)
    dec = [np.array([1, 0, 1, 0], bool), np.array([0, 1, 1, 0], bool),
           np.array([1, 1, 0, 0], bool)]
    draws = iter(dec)
    monkeypatch.setattr(JA.jax.random, "bernoulli",
                        lambda *a, **k: jnp.asarray(next(draws)))
    want = np.asarray(JA.augment_batch(jax.random.key(0), jnp.asarray(x)))
    got = augment_batch(torch.from_numpy(x),
                        tuple(torch.from_numpy(d) for d in dec))
    np.testing.assert_array_equal(got.numpy(), want)
    if shape[1] != shape[2]:           # no rotation for non-square patches
        assert got.shape == x.shape


def test_decisions_come_from_the_generator():
    a = draw_decisions(torch.Generator().manual_seed(5), 64)
    b = draw_decisions(torch.Generator().manual_seed(5), 64)
    c = draw_decisions(torch.Generator().manual_seed(6), 64)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert any(not torch.equal(u, v) for u, v in zip(a, c))
    assert all(d.dtype == torch.bool and 8 < int(d.sum()) < 56 for d in a)
    with pytest.raises(ValueError, match="Generator"):
        preprocess_batch(torch.zeros(2, 8, 8, 3, dtype=torch.uint8),
                         DataConfig(hr_patch=8), augment=True)


@pytest.mark.parametrize("hw", [(32, None), (32, 24)])
def test_synthetic_patches_equal_byte_for_byte(hw):
    cfg = dict(hr_patch=hw[0], hr_patch_w=hw[1], batch_size=3)
    a, b = iter(SyntheticPatches(DataConfig(**cfg), seed=7)), \
        iter(JSynthetic(JDataConfig(**cfg), seed=7))
    for _ in range(3):
        np.testing.assert_array_equal(next(a), next(b))


def _image_dir(path, n, size, seed):
    path.mkdir()
    for i in range(n):
        Image.fromarray(_u8(seed + i, (*size, 3))).save(path / f"im{i}.png")
    return str(path)


@pytest.mark.parametrize("workers", [1, 3])
def test_patch_loader_matches_and_resumes(tmp_path, workers):
    root = _image_dir(tmp_path / "hr", 5, (40, 56), 10)
    cfg = dict(dataset_dir=root, hr_patch=32, batch_size=4,
               n_workers=workers)
    port, ref = PatchLoader(DataConfig(**cfg), seed=3), \
        JPatchLoader(JDataConfig(**cfg), seed=3)
    it, jit_ = iter(port), iter(ref)
    batches = [next(it) for _ in range(4)]
    for b in batches:
        np.testing.assert_array_equal(b, next(jit_))
    # resume after two batches replays batches three and four
    resumed = PatchLoader(DataConfig(**cfg), seed=0)
    resumed.load_state_dict({"seed": 3, "step": 2})
    it2 = iter(resumed)
    np.testing.assert_array_equal(next(it2), batches[2])
    np.testing.assert_array_equal(next(it2), batches[3])
    assert resumed.state_dict() == {"seed": 3, "step": 4}


def test_paired_loader_and_prefetch(tmp_path):
    hr = _image_dir(tmp_path / "hr", 3, (64, 64), 20)
    lr = _image_dir(tmp_path / "lr", 3, (16, 16), 30)
    assert [tuple(p.split("/")[-1] for p in pr)
            for pr in pair_images(hr, lr)] == [(f"im{i}.png",) * 2
                                               for i in range(3)]
    cfg = dict(dataset_dir=hr, lr_dir=lr, hr_patch=32, batch_size=2,
               n_workers=1)
    it = iter(PatchLoader(DataConfig(**cfg), seed=1))
    jit_ = iter(JPatchLoader(JDataConfig(**cfg), seed=1))
    got = list(zip(range(3), device_prefetch(it, 2, "cpu")))
    for _, b in got:
        want = next(jit_)
        assert b["hr"].dtype == torch.uint8
        assert b["hr"].shape == (2, 32, 32, 3) and \
            b["lr"].shape == (2, 8, 8, 3)
        for k in ("hr", "lr"):
            np.testing.assert_array_equal(b[k].numpy(), want[k])
    (tmp_path / "lr" / "im2.png").unlink()
    with pytest.raises(FileNotFoundError, match="no LR partner"):
        pair_images(hr, lr)
