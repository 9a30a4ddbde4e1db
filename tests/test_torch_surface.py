"""The last of the JAX package's public surface in the port, and the
port's headline bench, on the CPU.

- ``train.steps.eval_batch`` against the JAX package's ``eval_batch``:
  one seeded JAX generator (1 RRDB, 16 filters, growth 8, ``lax``,
  float32) carried across with ``import_torch.state_dict_from_flax``, a
  seeded uint8 batch (2, 32, 32, 3) as plain HR and as a paired
  ``{"hr", "lr"}`` dict.  Tolerance 1e-3 dB: the two generators agree to
  float32 summation order (``tests/test_parity.py``'s 2e-5), which moves
  the PSNR by orders of magnitude less.
- ``import_torch.import_vgg`` against the JAX package's ``import_vgg``
  (through ``vgg_state_dict_from_flax``) and against ``tools.convert_vgg``
  + ``load_vgg_params``, bit for bit, on the seeded torch spec, under
  both key forms; the port's VGG trunk on its weights against the spec
  at 1e-4 (``tests/test_parity.py``'s VGG tolerance).
- ``bench.run`` at 1 block, 16 filters, one 16² tile, 2 forwards per
  chain: one JSON line with ``bench.py``'s keys, the forwards through
  the dense-block wrapper, no kernel launch on the CPU; and ``python -m
  super_resolution_tpu_torch.bench`` without a card refuses.
- ``eval_batch``'s card checks (``tests/torch_checks.py``) at 23
  blocks, 16 filters, the plain dense block standing in for the kernel:
  they pass it, and fail a dropped tap planted into the "kernel"'s
  weights.
- ``chip_smoke.py``'s ``[grad-bench]`` bound, on ``tools.grad_bench``'s
  seeded block at (2, 64, 24²) bf16, where the plain block stands in for
  the kernels: its dx is within (1 + delta) times cuDNN's distance from
  the float32 dx, and a dropped tap, a dropped slice or a flipped kernel
  in its forward or backward is not.

One torch thread per test.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.config import GeneratorConfig as JGeneratorConfig
from super_resolution_tpu.config import TrainConfig as JTrainConfig
from super_resolution_tpu.import_torch import import_vgg as jax_import_vgg
from super_resolution_tpu.train.state import build_models as j_build_models
from super_resolution_tpu.train.steps import eval_batch as jax_eval_batch
from super_resolution_tpu_torch import bench
from super_resolution_tpu_torch.config import GeneratorConfig, TrainConfig
from super_resolution_tpu_torch.device import no_tf32
from super_resolution_tpu_torch.import_torch import (
    import_vgg,
    state_dict_from_flax,
    vgg_state_dict_from_flax,
)
from super_resolution_tpu_torch.models import rrdb
from super_resolution_tpu_torch.models.vgg import VGGFeatures, load_vgg_params
from super_resolution_tpu_torch.ops.dense_block import (
    dense_block_train,
    pack_weight,
    unpack_weight,
)
from super_resolution_tpu_torch.ops.experiments_dense_block import _packed
from super_resolution_tpu_torch.tools import convert_vgg
from super_resolution_tpu_torch.tools.grad_bench import dx_of, make_inputs
from super_resolution_tpu_torch.tools.kernel_bench import lax_block
from super_resolution_tpu_torch.train.steps import eval_batch
from torch_checks import (
    EVAL_BATCH_PLAIN_DB,
    GRAD_BENCH_F32_DELTA,
    eval_batch_checks,
    sr_vs_plain,
)
from torch_spec import VGGFeaturesTorch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_blocks=1, filters=16, growth=8, conv_impl="lax")
PSNR_ATOL = 1e-3
# G's last conv scaled up: a freshly drawn G gives an almost constant SR
# image, whose PSNR hardly depends on the generator
SR_GAIN = 30.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs six workers on one
    host, and spinning thread pools would slow the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def generators():
    jcfg = dataclasses.replace(JTrainConfig(),
                               generator=JGeneratorConfig(**SMALL),
                               compute_dtype="float32")
    g, _, _ = j_build_models(jcfg)
    params = g.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))["params"]
    params = {**params, "conv_last": jax.tree.map(
        lambda a: a * SR_GAIN, params["conv_last"])}
    cfg = TrainConfig(generator=GeneratorConfig(**SMALL),
                      compute_dtype="float32")
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params))
    return jcfg, params, cfg, sd


@pytest.mark.parametrize("paired", [False, True], ids=["hr", "paired"])
def test_eval_batch_matches_jax(generators, paired):
    jcfg, params, cfg, sd = generators
    rng = np.random.default_rng(7)
    hr = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    batch = ({"hr": hr, "lr": rng.integers(0, 256, (2, 8, 8, 3),
                                           dtype=np.uint8)}
             if paired else hr)
    want = float(jax_eval_batch(jcfg, params,
                                jax.tree.map(jnp.asarray, batch))["psnr"])
    got = eval_batch(cfg, sd, batch, device="cpu")
    assert set(got) == {"psnr"} and got["psnr"].dim() == 0
    assert np.isfinite(want) and 5.0 < want < 40.0
    assert float(got["psnr"]) == pytest.approx(want, abs=PSNR_ATOL)
    # the uint8 batch as tensors gives the same value
    as_tensors = ({k: torch.from_numpy(v) for k, v in batch.items()}
                  if paired else torch.from_numpy(batch))
    assert float(eval_batch(cfg, sd, as_tensors, device="cpu")["psnr"]) \
        == float(got["psnr"])


def test_eval_batch_refuses_a_missing_card(generators):
    _, _, cfg, sd = generators
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_batch(cfg, sd, np.zeros((1, 32, 32, 3), np.uint8))


@pytest.fixture(scope="module")
def vgg_spec():
    torch.manual_seed(4)
    spec = VGGFeaturesTorch().eval()
    sd = spec.state_dict()
    return spec, {"features": sd,
                  "bare": {k.split(".", 1)[1]: v for k, v in sd.items()}}


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("form", ["features", "bare"])
def test_import_vgg_matches_jax(vgg_spec, form):
    _, sds = vgg_spec
    got = import_vgg(sds[form])
    assert len(got) == 32 and got["conv0.weight"].shape == (64, 3, 3, 3)
    want = vgg_state_dict_from_flax(jax.tree.map(
        np.asarray, jax_import_vgg(sds[form])["params"]))
    _equal(got, want)
    # numpy arrays, as the JAX function takes them
    _equal(import_vgg({k: v.numpy() for k, v in sds[form].items()}), got)


def test_import_vgg_prefers_the_features_keys(vgg_spec):
    _, sds = vgg_spec
    both = {**{k: torch.zeros_like(v) for k, v in sds["bare"].items()},
            **sds["features"]}
    _equal(import_vgg(both), import_vgg(sds["features"]))


@pytest.mark.parametrize("form", ["features", "bare"])
def test_import_vgg_missing_conv_raises(vgg_spec, form):
    _, sds = vgg_spec
    prefix = "features.34" if form == "features" else "34"
    cut = {k: v for k, v in sds[form].items()
           if not k.startswith(prefix + ".")}
    with pytest.raises(KeyError, match="features index 34"):
        import_vgg(cut)


def test_import_vgg_equals_the_npz_route_and_runs_the_spec(vgg_spec,
                                                           tmp_path):
    spec, sds = vgg_spec
    pth, npz = str(tmp_path / "vgg19.pth"), str(tmp_path / "vgg19.npz")
    torch.save(sds["features"], pth)
    convert_vgg.convert(pth, npz)
    weights = import_vgg(sds["features"])
    _equal(weights, load_vgg_params(npz))

    vgg = VGGFeatures()
    vgg.load_state_dict(weights, strict=True)
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = spec(x).permute(0, 2, 3, 1).numpy()
    got = vgg(x.permute(0, 2, 3, 1)).numpy()
    assert got.shape == want.shape == (1, 2, 2, 512)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_bench_run_on_the_cpu(monkeypatch, capsys):
    """The bench's control flow at a tiny size: its forwards go through
    ``models.rrdb``'s dense-block wrapper (the kernel on the card; here
    its plain version, so no launch is counted)."""
    calls = []
    wrapper = rrdb.dense_block

    def spy(*args, **kw):
        calls.append(1)
        return wrapper(*args, **kw)

    monkeypatch.setattr(rrdb, "dense_block", spy)
    gcfg = GeneratorConfig(n_blocks=1, filters=16, growth=8,
                           init=bench.SEED_INIT, conv_impl="pallas_cf")
    res = bench.run(gcfg, batch=1, tile=16, iters=2, device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == res["result"]
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "rrdb23_x4_infer_throughput"
    assert line["unit"] == "megapixels/sec/chip"
    assert np.isfinite(line["value"]) and line["value"] > 0
    # from the unrounded rate, as bench.run rounds it
    out_mp = 1 * (16 * gcfg.scale) ** 2 / 1e6
    mp_s = out_mp / (res["ms_per_batch"] / 1e3)
    assert line["vs_baseline"] == round(mp_s / bench.CPU_REFERENCE_MP_S, 1)
    assert res["forwards"] == (1 + bench.CHAINS) * 2
    assert len(calls) == res["forwards"] * gcfg.n_blocks * gcfg.n_dense
    assert res["launches"] == {"dense_block": 0}
    assert all(e.startswith("[bench] ") for e in err.strip().splitlines())
    assert json.loads(err.strip().splitlines()[-1].split(
        "launches: ", 1)[1]) == res["launches"]


def test_bench_without_a_card_refuses():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "super_resolution_tpu_torch.bench"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "'cuda'" in p.stderr and "no CUDA device" in p.stderr


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
def test_eval_batch_checks_pass_plain_and_fail_a_planted_fault(dtype, fault):
    """``eval_batch``'s card checks (``torch_checks.eval_batch_checks``)
    at the full depth and a small width, the plain dense block standing
    in for the kernel: each call within ``TOL`` of its plain version and
    the SR batch within the model bounds, and a dropped tap in the
    "kernel"'s weights past the call bound in both dtypes and past the
    SR bound in float32.  Full depth, because ``TOL``'s absolute term
    hides the fault in the first blocks, whose values are of order
    1e-2; the deeper blocks' are of order 1."""
    gcfg = GeneratorConfig(filters=16, growth=8,     # 23 blocks
                           init=bench.SEED_INIT)
    sd = rrdb.RRDBNet(gcfg, torch.Generator().manual_seed(0)).state_dict()
    cfg = TrainConfig(generator=gcfg, compute_dtype=dtype)
    hr = np.random.default_rng(6).integers(0, 256, (2, 32, 32, 3),
                                           dtype=np.uint8)
    plain, sr_plain, psnr, sr, block = eval_batch_checks(cfg, sd, hr, "cpu",
                                                         fault)
    torch_dtype = getattr(torch, dtype)
    _, sr_ok = sr_vs_plain(sr, sr_plain, torch_dtype)
    assert len(block.excess) == gcfg.n_blocks * gcfg.n_dense
    if not fault:
        assert block.worst() <= 0 and sr_ok
        assert abs(psnr - plain) <= EVAL_BATCH_PLAIN_DB[torch_dtype]
    else:
        assert block.worst() > 0
        assert dtype == "bfloat16" or not sr_ok


def _edit(w, fn):
    """A packed weight with ``fn`` applied to its OIHW view."""
    o = unpack_weight(w).clone()
    fn(o)
    return pack_weight(o).to(w.dtype)


# (side, conv, change of its OIHW weight), each a fault of the kind the
# bound is there to catch
FAULTS = {
    "fwd_tap": ("forward", 2, lambda o: o[:, :, 1, 1].zero_()),
    "fwd_slice": ("forward", 4, lambda o: o[:, 96:128].zero_()),
    "bwd_tap": ("backward", 1, lambda o: o[:, :, 2, 2].zero_()),
    "bwd_flip": ("backward", 3, lambda o: o.copy_(o.flip(2, 3))),
    "bwd_slice": ("backward", 4, lambda o: o[:, 160:192].zero_()),
}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_grad_bench_bound_passes_rounding_and_fails_faults(monkeypatch,
                                                           fault):
    ops = importlib.import_module("super_resolution_tpu_torch.ops.dense_block")
    x, tgt, ws, bs = make_inputs(2, 24, 24, torch.device("cpu"))
    wp, bp = _packed(x, ws, bs)
    if fault is not None:
        side, k, change = FAULTS[fault]
        name = f"plain_{side}"
        orig = getattr(ops, name)

        def faulty(a, weights, *args, **kw):
            weights = list(weights)
            weights[k] = _edit(weights[k], change)
            return orig(a, weights, *args, **kw)

        monkeypatch.setattr(ops, name, faulty)
    dx = dx_of(lambda a: dense_block_train(a, wp, bp, res_scale=0.2,
                                           slope=0.2), x, tgt).float()
    dx_lax = dx_of(lambda a: lax_block(a, ws, bs), x, tgt).float()
    with no_tf32():
        dx_f32 = dx_of(lambda a: lax_block(a, [w.float() for w in ws], bs),
                       x.float(), tgt)
    ratio = float((dx - dx_f32).abs().max()) \
        / float((dx_lax - dx_f32).abs().max())
    if fault is None:
        assert ratio <= 1.0 + GRAD_BENCH_F32_DELTA
    else:
        assert ratio > 2.0 * (1.0 + GRAD_BENCH_F32_DELTA)
