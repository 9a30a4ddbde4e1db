"""The port stands alone: no module of ``super_resolution_tpu_torch``,
and not ``chip_smoke.py``, imports JAX, Flax, Optax, Orbax or the JAX
package.  Read with ``ast``, so nothing is imported to check it."""

import ast
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
