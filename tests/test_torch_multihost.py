"""Multi-host training of the port (``parallel/multihost.py``) on the CPU:

- two ``cli train --multihost --num_processes 2 --process_id {0,1}
  --data_parallel 2 --device cpu`` processes meeting at a free local
  port (each a host with one gloo rank): both exit 0, only rank 0 wrote
  its logs and the checkpoint, which equals a single-process run's of
  the same two steps at the JAX package's data-parallel tolerances
  (``tests/test_dp.py:91-97``: parameters and D's statistics 1e-3,
  losses 5e-4), and both resume from it;
- the ``process_*`` helpers at world size 1, without a group and in a
  group of one rank;
- the loaders' ``part=`` contract: the ranks' rows concatenate to the
  single-process batch bit for bit (``tests/test_multihost.py:40-106``);
- the launcher's argument errors.

The run is the one of ``tests/test_torch_train_loop.py``: one RRDB at
the canonical width, 32 × 32 HR patches, float32, ``train_gan_dfm``,
one warmup step and one GAN step, global batch 2.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.config import DataConfig
from super_resolution_tpu_torch.data.pipeline import (
    PatchLoader,
    SyntheticPatches,
)
from super_resolution_tpu_torch.parallel import dp, multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--dtype", "float32", "--preset",
         "train_gan_dfm", "--residual_blocks", "1", "--batch_size", "2",
         "--hr_height", "32", "--seed", "3", "--warmup_batches", "1",
         "--dataset_dir", "/nonexistent/synthetic"]
PARAM_ATOL, LOSS_ATOL = 1e-3, 5e-4
HOST_TIMEOUT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hosts(tmp, port, ck_for, *extra):
    """Both hosts of a 2-rank group, as subprocesses, joined; host i
    writes its logs to log{i} and its checkpoints to ``ck_for(i)``."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "super_resolution_tpu_torch.cli", "train",
         *SMALL, "--multihost", "--coordinator", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(i),
         "--data_parallel", "2", "--checkpoint_dir", str(ck_for(i)),
         "--log_dir", str(tmp / f"log{i}"), *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=HOST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _tree(ck, step):
    return torch.load(os.path.join(ck, str(step), "state.pt"),
                      map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    rcs, outs = _hosts(tmp, _free_port(), lambda i: tmp / f"ck{i}",
                       "--steps", "2")
    single = tmp / "single"
    assert main(["train", *SMALL, "--steps", "2", "--checkpoint_dir",
                 str(single / "ck"), "--log_dir", str(single / "log")]) == 0
    return tmp, rcs, outs


def test_both_hosts_exit_0_and_only_rank_0_writes(runs):
    tmp, rcs, outs = runs
    assert rcs == [0, 0], outs
    assert "backend gloo" in outs[0] and "ranks 1..1 of 2" in outs[1]
    assert os.path.isfile(tmp / "ck0" / "2" / "state.pt")
    assert os.path.isfile(tmp / "log0" / "metrics.jsonl")
    assert not os.path.exists(tmp / "ck1")
    assert not os.path.exists(tmp / "log1")


def test_checkpoint_equals_the_single_process_run(runs):
    tmp = runs[0]
    got, want = _tree(tmp / "ck0", 2), _tree(tmp / "single" / "ck", 2)
    assert got["step"] == want["step"] == 2
    for tree in ("g", "d", "g_ema"):
        for k in want[tree]:
            np.testing.assert_allclose(got[tree][k].numpy(),
                                       want[tree][k].numpy(),
                                       atol=PARAM_ATOL, err_msg=k)
    # the logged losses are the global batch's
    with open(tmp / "log0" / "metrics.jsonl") as f:
        a = json.loads(f.readlines()[-1])
    with open(tmp / "single" / "log" / "metrics.jsonl") as f:
        b = json.loads(f.readlines()[-1])
    for k in ("loss_g", "loss_d", "loss_adv", "loss_pixel", "loss_percep"):
        assert abs(a[k] - b[k]) <= LOSS_ATOL, k


def test_both_hosts_resume_from_rank_0s_checkpoint(runs):
    tmp = runs[0]
    rcs, outs = _hosts(tmp, _free_port(), lambda i: tmp / "ck0",
                       "--steps", "3", "--resume")
    assert rcs == [0, 0], outs
    assert all("resumed from step 2" in o for o in outs)
    assert _tree(tmp / "ck0", 3)["step"] == 3


def test_process_helpers_at_world_size_1():
    """Without a group, and in a group of one rank (through
    ``initialize``), every helper is the single-process answer."""
    def check():
        assert multihost.process_count() == 1
        assert multihost.process_index() == 0
        assert multihost.is_primary()
        assert multihost.data_part() == (0, 1)
        assert multihost.local_rows(8) == 8

    check()
    assert not dp.active()
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                         backend="gloo", timeout_s=60)
    try:
        assert dp.active()
        check()
        t = torch.arange(4.0)
        assert torch.equal(dp.global_mean(t), t)
        assert torch.equal(dp.average_gradients([t])[0], t)
    finally:
        torch.distributed.destroy_process_group()
    assert not dp.active()


def test_launch_argument_errors():
    with pytest.raises(ValueError, match="host 2 of 2"):
        multihost.launch(print, (), "127.0.0.1:1", 2, 2, 2, "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        multihost.launch(print, (), "127.0.0.1:1", 2, 0, 3, "cpu")


def _write_images(tmp_path, n=3, size=40):
    rng = np.random.RandomState(0)
    d = tmp_path / "hr"
    d.mkdir(exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (size, size, 3),
                                    dtype=np.uint8)).save(d / f"{i}.png")
    return str(d)


@pytest.mark.parametrize("count", [2, 4])
def test_patch_loader_partition_concat_exact(tmp_path, count):
    root = _write_images(tmp_path)
    cfg = DataConfig(dataset_dir=root, batch_size=4, hr_patch=16,
                     n_workers=1)
    full = iter(PatchLoader(cfg, seed=3))
    parts = [iter(PatchLoader(cfg, seed=3, part=(i, count)))
             for i in range(count)]
    for _ in range(3):
        want = next(full)
        np.testing.assert_array_equal(
            np.concatenate([next(p) for p in parts]), want)


def test_patch_loader_partition_paired(tmp_path):
    rng = np.random.RandomState(1)
    hr_d, lr_d = tmp_path / "hr", tmp_path / "lr"
    hr_d.mkdir(), lr_d.mkdir()
    for i in range(3):
        hr = rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
        Image.fromarray(hr).save(hr_d / f"{i}.png")
        Image.fromarray(hr[::4, ::4]).save(lr_d / f"{i}.png")
    cfg = DataConfig(dataset_dir=str(hr_d), lr_dir=str(lr_d),
                     batch_size=4, hr_patch=16, n_workers=1)
    full = iter(PatchLoader(cfg, seed=5))
    parts = [iter(PatchLoader(cfg, seed=5, part=(i, 2))) for i in range(2)]
    for _ in range(2):
        want = next(full)
        lots = [next(p) for p in parts]
        for key in ("hr", "lr"):
            np.testing.assert_array_equal(
                np.concatenate([b[key] for b in lots]), want[key])


def test_synthetic_patches_partition():
    cfg = DataConfig(batch_size=8, hr_patch=16)
    full = iter(SyntheticPatches(cfg, seed=2))
    parts = [iter(SyntheticPatches(cfg, seed=2, part=(i, 4)))
             for i in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([next(p) for p in parts]), next(full))
