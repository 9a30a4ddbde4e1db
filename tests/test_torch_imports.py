"""The port stands alone: no module of ``super_resolution_tpu_torch``,
and not ``chip_smoke.py``, imports JAX, Flax, Optax, Orbax or the JAX
package.  Read with ``ast``, so nothing is imported to check it.

And the port has the JAX package's public surface: every name the JAX
package's ``__init__`` files export, and each function of the last
slice, imports from the same path in both packages, except the JAX
idioms that ROADMAP.md lists as not ported."""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "super_resolution_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(
            ROOT, "super_resolution_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_has_the_files_it_should():
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for want in ("chip_smoke.py", "super_resolution_tpu_torch/cli.py",
                 "super_resolution_tpu_torch/bench.py",
                 "super_resolution_tpu_torch/serve.py",
                 "super_resolution_tpu_torch/models/rrdb.py",
                 "super_resolution_tpu_torch/ops/dense_block.py",
                 "super_resolution_tpu_torch/ops/conv3x3.py",
                 "super_resolution_tpu_torch/parallel/tiling.py",
                 "super_resolution_tpu_torch/import_torch.py",
                 "super_resolution_tpu_torch/checkpoint.py",
                 "super_resolution_tpu_torch/losses.py",
                 "super_resolution_tpu_torch/metrics.py",
                 "super_resolution_tpu_torch/models/discriminator.py",
                 "super_resolution_tpu_torch/models/vgg.py",
                 "super_resolution_tpu_torch/data/pipeline.py",
                 "super_resolution_tpu_torch/train/state.py",
                 "super_resolution_tpu_torch/train/steps.py",
                 "super_resolution_tpu_torch/train/loop.py",
                 "super_resolution_tpu_torch/train/evaluate.py",
                 "super_resolution_tpu_torch/halo_sweep.py",
                 "super_resolution_tpu_torch/ops/upsample_conv.py",
                 "super_resolution_tpu_torch/parallel/dp.py",
                 "super_resolution_tpu_torch/parallel/multihost.py",
                 "super_resolution_tpu_torch/data/grain_source.py",
                 *(f"super_resolution_tpu_torch/tools/{t}.py" for t in (
                     "convert_vgg", "grad_bench", "verify_grads_onchip",
                     "train_bench", "profile_gan", "tiled_bench",
                     "halo_parity", "demo_train_eval"))):
        assert want in rel
    for source in ("dense_block.cu", "dense_block_bwd.cu", "conv3x3.cu",
                   "conv3x3_tile.cuh"):
        assert os.path.isfile(os.path.join(
            ROOT, "super_resolution_tpu_torch", "csrc", source))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


# the names ported last that no JAX ``__init__`` re-exports (those are
# test_package_exports_what_the_jax_package_does's), at the JAX
# package's paths (ROADMAP.md Queue 1)
SURFACE = [
    ("", "__version__"),
    ("train.steps", "eval_batch"),
    ("import_torch", "import_vgg"),
]
# JAX idioms the port does not have (ROADMAP.md Queue 1, "Not to port")
NOT_PORTED = {"parallel": {"BATCH_AXIS", "batch_sharded", "make_mesh",
                           "replicated", "shard_batch_iter",
                           "shard_state"}}
PACKAGES = ("", "models", "ops", "train", "parallel", "data")


def _module(package, path):
    return importlib.import_module(".".join(p for p in (package, path) if p))


@pytest.mark.parametrize("path,name", SURFACE,
                         ids=[f"{p or 'top'}.{n}" for p, n in SURFACE])
def test_surface_name_in_both_packages(path, name):
    ours = getattr(_module("super_resolution_tpu_torch", path), name)
    theirs = getattr(_module("super_resolution_tpu", path), name)
    if name == "__version__":
        assert ours == theirs
    else:
        assert callable(ours) and callable(theirs)


@pytest.mark.parametrize("path", PACKAGES, ids=lambda p: p or "top")
def test_package_exports_what_the_jax_package_does(path):
    jax_init = os.path.join(ROOT, "super_resolution_tpu", path, "__init__.py")
    with open(jax_init) as f:
        tree = ast.parse(f.read())
    exported = {a.asname or a.name for node in tree.body
                if isinstance(node, ast.ImportFrom) for a in node.names}
    ours = _module("super_resolution_tpu_torch", path)
    missing = sorted(n for n in exported - NOT_PORTED.get(path, set())
                     if not hasattr(ours, n))
    assert not missing, f"super_resolution_tpu_torch.{path} lacks {missing}"


def test_top_level_import_stays_cheap():
    """Importing the package builds no kernel and loads neither the
    models nor the CLI (checked in a fresh interpreter)."""
    import json
    import subprocess
    import sys

    code = ("import json, sys, super_resolution_tpu_torch; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.startswith('super_resolution_tpu_torch'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out) == ["super_resolution_tpu_torch",
                         "super_resolution_tpu_torch.config"]
