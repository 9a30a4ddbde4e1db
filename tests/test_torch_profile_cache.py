"""``--profile_dir`` (``metrics.profiler_trace``) and the kernels' build
directory as the compile cache (``build.set_build_dir``,
``build.temporary_build_dir``; ``--compile_cache_dir``,
``--no_compile_cache``), on the CPU."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from super_resolution_tpu_torch import build
from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.metrics import profiler_trace
from torch_spec import RRDBNetTorch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["train", "--device", "cpu", "--dtype", "float32", "--preset",
         "train_gan_dfm", "--residual_blocks", "1", "--batch_size", "2",
         "--hr_height", "32", "--warmup_batches", "1",
         "--dataset_dir", "/nonexistent/synthetic"]


@pytest.fixture
def keep_build_dir(monkeypatch):
    """The CLI points ``build.BUILD_DIR`` elsewhere; put it back."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)


def _traces(d):
    return sorted(glob.glob(os.path.join(str(d), "*.pt.trace.json")))


def test_profiler_trace_none_is_a_no_op(tmp_path):
    before = set(os.listdir(tmp_path))
    with profiler_trace(None):
        torch.ones(3).sum()
    with profiler_trace(""):
        torch.ones(3).sum()
    assert set(os.listdir(tmp_path)) == before


def test_profiler_trace_writes_a_trace(tmp_path):
    d = tmp_path / "trace"
    with profiler_trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = _traces(d)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_cli_train_profile_dir(tmp_path):
    assert main([*TRAIN, "--steps", "2", "--checkpoint_dir",
                 str(tmp_path / "ck"), "--profile_dir",
                 str(tmp_path / "p")]) == 0
    (path,) = _traces(tmp_path / "p")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names


def test_cli_train_profile_dir_traces_rank_0_alone(tmp_path):
    assert main([*TRAIN, "--steps", "1", "--data_parallel", "2",
                 "--checkpoint_dir", str(tmp_path / "ck"), "--profile_dir",
                 str(tmp_path / "p")]) == 0
    assert len(_traces(tmp_path / "p")) == 1


def test_compile_cache_dir_is_where_libraries_resolve(tmp_path,
                                                      keep_build_dir):
    torch.manual_seed(0)
    pth = str(tmp_path / "g.pth")
    torch.save(RRDBNetTorch(nf=16, nb=1, gc=8).state_dict(), pth)
    src = str(tmp_path / "lr.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(src)
    cache = tmp_path / "cache"
    assert main(["upscale", "--image", src, "--checkpoint", pth, "--out",
                 str(tmp_path / "sr.png"), "--device", "cpu",
                 "--compile_cache_dir", str(cache)]) == 0
    assert build.BUILD_DIR == str(cache)
    for name in build.SOURCES:
        path = build.library_path(name)
        assert os.path.dirname(path) == str(cache)
        # content-addressed names: the same as under the default dir
        assert os.path.basename(path).startswith(f"lib{name}-")


def test_no_compile_cache_builds_into_a_temporary_dir(tmp_path,
                                                      keep_build_dir):
    pth = str(tmp_path / "g.pth")
    torch.save(RRDBNetTorch(nf=16, nb=1, gc=8).state_dict(), pth)
    src = str(tmp_path / "lr.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(src)
    default = build.BUILD_DIR
    assert main(["upscale", "--image", src, "--checkpoint", pth, "--out",
                 str(tmp_path / "sr.png"), "--device", "cpu",
                 "--no_compile_cache"]) == 0
    assert build.BUILD_DIR != default
    assert os.path.basename(build.BUILD_DIR).startswith("sr_torch_build_")
    assert os.path.isdir(build.BUILD_DIR)
    # and the directory goes with the process that made it
    out = subprocess.run(
        [sys.executable, "-c",
         "from super_resolution_tpu_torch import build; "
         "print(build.temporary_build_dir())"],
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=60, check=True).stdout.strip()
    assert out and not os.path.exists(out)


def test_nothing_is_built_at_import(tmp_path):
    """Importing every module of the port starts no nvcc and creates no
    build directory."""
    code = f"""
import importlib, os, pkgutil
from super_resolution_tpu_torch import build
build.set_build_dir({str(tmp_path / 'b')!r})
def boom(*a, **k):
    raise AssertionError("nvcc started at import")
build._start_nvcc = boom
import super_resolution_tpu_torch as pkg
n = 0
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    n += 1
assert not os.path.exists(build.BUILD_DIR)
print(n)
"""
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 30
