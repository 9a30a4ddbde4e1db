"""The port's grain loader (``super_resolution_tpu_torch.data.grain_source``)
against the JAX package's on the CPU: the same files, seed and ``part``
give the same bytes over three batches, HR-only and paired, whole and
in parts; the JSON state round trip and resume; the parts concatenate
to the whole stream; ``train()`` and ``cli train --loader grain``
stopped, resumed from the checkpoint (whose ``data.json`` holds grain's
iterator state) and run on equal a straight run in every state tensor,
bit for bit, although the device prefetch runs ahead of the batch the
checkpoint saved; and without the ``grain`` package the loader and
``cli train --loader grain`` raise naming it, before any step.

Sizes: 40 x 40 source images, 16 x 16 patches, batches of 2; training
at one RRDB, float32, batch 2 of 32 x 32 (the dense blocks' plain
versions), one warmup step, then GAN steps; one torch thread per test.  Every
comparison is exact: both loaders run the same grain chain over
byte-identical decode and crop functions.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from super_resolution_tpu.config import DataConfig as JDataConfig
from super_resolution_tpu.data.grain_source import (
    GrainPatchLoader as JGrainPatchLoader,
)
from super_resolution_tpu_torch.checkpoint import latest_step
from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.config import (
    DataConfig,
    GeneratorConfig,
    preset,
)
from super_resolution_tpu_torch.data.grain_source import GrainPatchLoader
from super_resolution_tpu_torch.train import train
from super_resolution_tpu_torch.train.state import state_dict



# grain's shuffle (index_shuffle) costs about 1 / the dataset's size per
# record (5 ms a record over 5 files, 0.15 ms over 256), and every
# iterator start prefetches hundreds of records: a few hundred files keep
# the tests short
N_FILES = 256

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs six workers on one
    host, and spinning thread pools would slow the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("grain_img")
    rng = np.random.RandomState(0)
    for i in range(N_FILES):
        Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8)
                        ).save(root / f"i{i:03d}.png")
    return str(root)


@pytest.fixture(scope="module")
def paired_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("grain_pair")
    hr_dir, lr_dir = root / "hr", root / "lr"
    hr_dir.mkdir(), lr_dir.mkdir()
    rng = np.random.RandomState(17)
    for i in range(N_FILES // 2):
        lr = rng.randint(0, 256, (12, 12, 3), np.uint8)
        Image.fromarray(lr).save(lr_dir / f"p{i:03d}.png")
        Image.fromarray(np.kron(lr, np.ones((4, 4, 1), np.uint8))).save(
            hr_dir / f"p{i:03d}.png")
    return str(hr_dir), str(lr_dir)


def _cfgs(image_dir, paired_dirs, mode, batch=2):
    kw = dict(hr_patch=16, batch_size=batch, n_workers=0)
    if mode == "paired":
        kw.update(dataset_dir=paired_dirs[0], lr_dir=paired_dirs[1])
    else:
        kw.update(dataset_dir=image_dir)
    return DataConfig(**kw), JDataConfig(**kw)


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
        return
    assert a.dtype == np.uint8 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("part", [(0, 1), (1, 2)])
@pytest.mark.parametrize("mode", ["hr", "paired"])
def test_batches_equal_the_jax_loader(image_dir, paired_dirs, mode, part):
    cfg, jcfg = _cfgs(image_dir, paired_dirs, mode)
    ours = iter(GrainPatchLoader(cfg, seed=1, part=part))
    ref = iter(JGrainPatchLoader(jcfg, seed=1, part=part))
    for _ in range(3):
        b = next(ours)
        _equal(b, next(ref))
    rows = 2 // part[1]
    hr = b["hr"] if mode == "paired" else b
    assert hr.shape == (rows, 16, 16, 3)
    if mode == "paired":
        # the fixture's HRs are nearest-upsampled LRs: the LR crop came
        # from the paired file, aligned with the HR crop
        np.testing.assert_array_equal(
            b["hr"], np.kron(b["lr"], np.ones((1, 4, 4, 1), np.uint8)))


@pytest.mark.parametrize("mode", ["hr", "paired"])
def test_json_state_round_trip_and_resume(image_dir, paired_dirs, mode):
    cfg, jcfg = _cfgs(image_dir, paired_dirs, mode)
    ld = GrainPatchLoader(cfg, seed=2)
    it = iter(ld)
    next(it)
    next(it)
    state = json.loads(json.dumps(ld.state_dict()))   # the data.json trip
    expected = next(it)
    ld2 = GrainPatchLoader(cfg, seed=2)
    ld2.load_state_dict(state)
    _equal(next(iter(ld2)), expected)
    # the state is the JAX loader's state: it resumes the JAX stream
    jld = JGrainPatchLoader(jcfg, seed=2)
    jld.load_state_dict(state)
    _equal(next(iter(jld)), expected)


@pytest.mark.parametrize("count", [2])
def test_parts_concatenate_to_the_whole_stream(image_dir, count):
    cfg, _ = _cfgs(image_dir, None, "hr")
    whole = iter(GrainPatchLoader(cfg, seed=5))
    parts = [iter(GrainPatchLoader(cfg, seed=5, part=(i, count)))
             for i in range(count)]
    for _ in range(3):
        np.testing.assert_array_equal(
            next(whole), np.concatenate([next(p) for p in parts]))


def test_bad_part_raises(image_dir):
    cfg, _ = _cfgs(image_dir, None, "hr", batch=4)
    with pytest.raises(ValueError, match="does not split"):
        GrainPatchLoader(cfg, part=(0, 3))


def _tiny_cfg(image_dir, ckpt):
    import dataclasses

    return dataclasses.replace(
        preset("train_gan_dfm"),
        generator=GeneratorConfig(n_blocks=1),
        data=DataConfig(dataset_dir=image_dir, hr_patch=32, batch_size=2,
                        n_workers=0),
        compute_dtype="float32", warmup_batches=1, checkpoint_interval=2,
        checkpoint_dir=str(ckpt), seed=3)


def _tensors(tree, prefix=""):
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else ()):
        if isinstance(v, dict):
            out.update(_tensors(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v
    return out


def test_train_resumed_equals_straight(image_dir, tmp_path):
    """train() takes the grain loader; a run stopped after its warmup
    step and resumed into a GAN step equals a straight run of both in
    every state tensor, though the device prefetch ran ahead of the
    saved batch."""
    def loader(cfg):
        return GrainPatchLoader(cfg.data, seed=cfg.seed)

    cfg = _tiny_cfg(image_dir, tmp_path / "a")
    train(cfg, data_loader=loader(cfg), total_steps=1, device="cpu")
    with open(tmp_path / "a" / "1" / "data.json") as f:
        assert "grain_state" in json.load(f)
    resumed = train(cfg, data_loader=loader(cfg), total_steps=2,
                    resume=True, device="cpu")
    cfg_b = _tiny_cfg(image_dir, tmp_path / "b")
    straight = train(cfg_b, data_loader=loader(cfg_b), total_steps=2,
                     device="cpu")
    a, b = _tensors(state_dict(resumed)), _tensors(state_dict(straight))
    assert a.keys() == b.keys() and len(a) > 10
    for k in a:
        assert torch.equal(a[k], b[k]), k


CLI = ["--device", "cpu", "--dtype", "float32", "--preset", "train_gan_dfm",
       "--residual_blocks", "1", "--batch_size", "2", "--hr_height", "32",
       "--seed", "3", "--warmup_batches", "1", "--loader", "grain",
       "--n_cpu", "0"]


def test_cli_train_grain_runs_and_resumes(image_dir, tmp_path):
    def run(ck, *extra):
        assert main(["train", "--dataset_dir", image_dir, "--checkpoint_dir",
                     str(ck), *CLI, *extra]) == 0

    run(tmp_path / "a", "--steps", "1")
    run(tmp_path / "a", "--steps", "2", "--resume")
    run(tmp_path / "b", "--steps", "2")
    assert latest_step(str(tmp_path / "a")) == 2
    load = lambda ck: torch.load(                         # noqa: E731
        os.path.join(str(ck), "2", "state.pt"), weights_only=True)
    a, b = _tensors(load(tmp_path / "a")), _tensors(load(tmp_path / "b"))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with open(tmp_path / "a" / "2" / "data.json") as f:
        assert json.load(f)["grain_state"]


def test_without_grain_it_raises_and_trains_nothing(image_dir, tmp_path,
                                                    monkeypatch):
    monkeypatch.setitem(sys.modules, "grain", None)
    cfg, _ = _cfgs(image_dir, None, "hr")
    with pytest.raises(ImportError, match="'grain' package"):
        GrainPatchLoader(cfg)
    with pytest.raises(ImportError, match="'grain' package"):
        main(["train", "--dataset_dir", image_dir, "--checkpoint_dir",
              str(tmp_path / "ck"), "--device", "cpu", "--dtype", "float32",
              "--residual_blocks", "1", "--batch_size", "2", "--hr_height",
              "32", "--loader", "grain", "--n_cpu", "0", "--steps", "1"])
    assert not os.path.exists(tmp_path / "ck")
