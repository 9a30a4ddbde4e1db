"""The port's check and asset tools against the JAX package on the CPU:

- ``tools.convert_vgg``: the npz equal bit for bit to the JAX tool's
  ``convert()`` on the same synthetic torchvision-layout ``.pth``, for
  both key families (``features.{i}`` and bare ``{i}``); a missing conv
  raises ``KeyError``; the port's VGG-19 from that npz matches the JAX
  VGG from it within 1e-4 of the largest feature (``tests/test_parity.py``).
- ``tools.verify_grads_onchip``: the gate passes on the CPU and fails
  on a fault injected into the plain dense-block backward.  It runs in
  float32 here: at batch 2 of 32², bf16 rounding alone (cuDNN-style
  bf16 autograd against the kernels' f32 accumulation) puts the worst
  parameter at 0.057 of its norm (23 blocks), a noise that shrinks with
  the pixel count (0.026 at 64²; on the card at the gate's 16 x 192² it
  is 0.0048), while in float32 the two paths agree to 4e-7; so float32
  is where this size can tell the gate's logic from rounding.
- ``tools.halo_parity``: max and mean tiled-vs-whole error per halo
  within 1e-6 of the JAX package's ``tiled_upscale`` against its whole
  frame (float32, ``lax``); in ``--val_dir`` mode the PSNRs within
  1e-3 dB.
- ``tools.demo_train_eval``: ``make_dataset`` writes the JAX tool's
  PNGs byte for byte (the function taken from the JAX file's ``ast``,
  since importing that script enables a compilation cache); a short run
  prints every ``[demo]`` line.

Sizes: a torch-spec generator of one block, width 16, growth 8; the
canonical generator cut to one RRDB at batch 2 of 32 x 32 HR for the
gate; a one-block demo at batch 2 on four 192 x 192 training images;
one torch thread per test.
"""

import ast
import dataclasses
import importlib.util
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from super_resolution_tpu.config import DataConfig as JDataConfig
from super_resolution_tpu.data import normalize as jnormalize
from super_resolution_tpu.halo_sweep import structured_probe as jprobe
from super_resolution_tpu.import_torch import (
    import_generator as jax_import_generator,
)
from super_resolution_tpu.import_torch import load_pth as jax_load_pth
from super_resolution_tpu.models import RRDBNet as JRRDBNet
from super_resolution_tpu.models import VGGFeatures as JVGG
from super_resolution_tpu.models import load_vgg_params as j_load_vgg
from super_resolution_tpu.parallel import tiled_upscale as j_tiled_upscale
from super_resolution_tpu_torch import config
from super_resolution_tpu_torch.models.vgg import VGGFeatures, load_vgg_params
from super_resolution_tpu_torch.tools import (
    convert_vgg,
    demo_train_eval,
    halo_parity,
    verify_grads_onchip,
)
from torch_spec import RRDBNetTorch, VGGFeaturesTorch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs six workers on one
    host, and spinning thread pools would slow the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool_module(name):
    """A module of the JAX package's ``tools/`` loaded by path under its
    own name (``tools/convert_vgg.py`` has no side effect at import)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def vgg_pth(tmp_path_factory):
    root = tmp_path_factory.mktemp("vgg")
    torch.manual_seed(0)
    sd = VGGFeaturesTorch().state_dict()
    paths = {"features": str(root / "features.pth"),
             "bare": str(root / "bare.pth")}
    torch.save(sd, paths["features"])
    torch.save({k.split(".", 1)[1]: v for k, v in sd.items()},
               paths["bare"])
    return paths


@pytest.mark.parametrize("family", ["features", "bare"])
def test_convert_vgg_equals_the_jax_tool(vgg_pth, family, tmp_path, capsys):
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    assert convert_vgg.main([vgg_pth[family], ours]) == 0
    assert "16 convs" in capsys.readouterr().out
    _jax_tool_module("convert_vgg").convert(vgg_pth[family], ref)
    a, b = np.load(ours), np.load(ref)
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 32
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


def test_convert_vgg_missing_conv_raises(vgg_pth, tmp_path):
    sd = torch.load(vgg_pth["features"], weights_only=True)
    del sd["features.34.weight"], sd["features.34.bias"]
    src = str(tmp_path / "cut.pth")
    torch.save(sd, src)
    with pytest.raises(KeyError, match="features index 34"):
        convert_vgg.convert(src, str(tmp_path / "cut.npz"))


def test_vgg_from_the_npz_matches_jax(vgg_pth, tmp_path):
    npz = str(tmp_path / "vgg.npz")
    convert_vgg.convert(vgg_pth["features"], npz)
    tv = VGGFeatures()
    tv.load_state_dict(load_vgg_params(npz), strict=True)
    x = np.random.default_rng(3).standard_normal((1, 32, 32, 3)) \
        .astype(np.float32)
    want = np.asarray(JVGG().apply(j_load_vgg(npz), jnp.asarray(x)))
    got = tv(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 2, 2, 512)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4,
                               rtol=1e-4)


GATE = ["--device", "cpu", "--batch", "2", "--hr", "32"]


@dataclasses.dataclass(frozen=True)
class OneBlock(config.GeneratorConfig):
    """The canonical generator cut to one RRDB (the gate builds its
    GeneratorConfig from ``config``; it has no depth flag)."""

    n_blocks: int = 1


@pytest.fixture
def float32_gate(monkeypatch):
    """The gate's preset in float32 (see the module docstring), on a
    one-RRDB generator."""
    preset = config.preset
    monkeypatch.setattr(config, "preset", lambda name: dataclasses.replace(
        preset(name), compute_dtype="float32"))
    monkeypatch.setattr(config, "GeneratorConfig", OneBlock)


def test_verify_grads_passes(float32_gate, capsys):
    assert verify_grads_onchip.main(GATE) == 0
    out = capsys.readouterr().out
    assert "lax -> training impl: lax" in out
    assert "pallas_cf -> training impl: pallas_cf" in out
    assert re.search(r"^worst leaf reldiff: \S+ at \S+; non-finite kernel "
                     r"grad elements: 0$", out, re.M)
    assert "ON-CHIP GRAD PARITY: OK" in out
    assert out.rstrip().splitlines()[-1].startswith("launches: ")


def test_verify_grads_fails_on_a_backward_fault(float32_gate, monkeypatch,
                                                capsys):
    db = importlib.import_module("super_resolution_tpu_torch.ops.dense_block")
    plain = db.plain_backward

    def faulty(*a, **kw):
        dx, dws, dbs = plain(*a, **kw)
        return dx, [d * 1.1 for d in dws], dbs

    monkeypatch.setattr(db, "plain_backward", faulty)
    with pytest.raises(SystemExit, match="worst leaf reldiff"):
        verify_grads_onchip.main(GATE)
    assert "ON-CHIP GRAD PARITY: OK" not in capsys.readouterr().out


@pytest.fixture(scope="module")
def halo_gen(tmp_path_factory):
    """(.pth path, JAX float32 lax forward) of one seeded generator."""
    root = tmp_path_factory.mktemp("halo")
    torch.manual_seed(0)
    pth = str(root / "gen.pth")
    torch.save(RRDBNetTorch(nf=16, nb=1, gc=8).state_dict(), pth)
    jv, jcfg = jax_import_generator(jax_load_pth(pth))
    jmodel = JRRDBNet(dataclasses.replace(jcfg, conv_impl="lax"),
                      dtype=jnp.float32)
    return pth, jax.jit(lambda x: jmodel.apply(jv, x))


def _port_infer(pth):
    sd, gcfg = halo_parity.load_generator(pth)
    return halo_parity.make_infer(
        sd, dataclasses.replace(gcfg, conv_impl="lax"), torch.float32,
        torch.device("cpu"))


def test_halo_parity_matches_jax(halo_gen, capsys):
    pth, jinfer = halo_gen
    dc = JDataConfig()
    x = jnormalize(jnp.asarray(jprobe(48)), dc.normalize_mean,
                   dc.normalize_std)
    whole = np.asarray(jinfer(x[None])[0], np.float32)
    std = np.asarray(dc.normalize_std, np.float32)
    rows = halo_parity.synthetic_rows(_port_infer(pth), 48, 16, (2, 4), 4,
                                      torch.device("cpu"))
    for row, halo in zip(rows, (2, 4)):
        tiled = np.asarray(j_tiled_upscale(jinfer, x, scale=4, tile=48,
                                           tile_w=16, halo=halo,
                                           tile_batch=1), np.float32)
        err01 = np.abs(tiled - whole) * std
        assert row["halo"] == halo and err01.max() > 0
        assert abs(row["max"] - float(err01.max())) <= 1e-6
        assert abs(row["mean"] - float(err01.mean())) <= 1e-6
    assert halo_parity.main(["--device", "cpu", "--checkpoint", pth,
                             "--frame", "48", "--tile_w", "16", "--halos",
                             "2,4"]) == 0
    out = capsys.readouterr().out
    assert "[halo] frame 48² whole-frame reference computed " \
           "(float32, lax)" in out
    for halo in (2, 4):
        assert re.search(rf"^\[halo\] halo= {halo} \(waste [\d.]+x at "
                         rf"tile_w=16\): max=\S+ mean=\S+ uint8_lsb_max=\d+ "
                         rf"psnr_vs_whole=[\d.]+dB$", out, re.M)


def test_halo_parity_val_dir_matches_jax(halo_gen, tmp_path, capsys):
    from super_resolution_tpu.data import denormalize as jdenormalize
    from super_resolution_tpu.metrics import psnr01 as jpsnr
    from super_resolution_tpu.ops import bicubic_downsample as jdown

    pth, jinfer = halo_gen
    val = tmp_path / "val"
    val.mkdir()
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate(((96, 128), (100, 84))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(val / f"v{i}.png")
    whole, tiled = halo_parity.val_dir_scores(
        _port_infer(pth), str(val), 16, (2, 4), 4, torch.device("cpu"))
    dc = JDataConfig()
    for i, name in enumerate(("v0.png", "v1.png")):
        with Image.open(val / name) as im:
            hr01 = np.asarray(im.convert("RGB"), np.float32) / 255.0
        h, w = (hr01.shape[0] // 4) * 4, (hr01.shape[1] // 4) * 4
        hr01 = jnp.asarray(hr01[:h, :w])
        lrn = jnormalize(jdown(hr01, 4), dc.normalize_mean, dc.normalize_std)

        def score(srn):
            sr01 = jnp.clip(jdenormalize(srn, dc.normalize_mean,
                                         dc.normalize_std), 0.0, 1.0)
            return float(jpsnr(sr01, hr01))

        assert abs(whole[i] - score(jinfer(lrn[None])[0])) <= 1e-3
        for halo in (2, 4):
            want = score(j_tiled_upscale(jinfer, lrn, scale=4, tile=h // 4,
                                         tile_w=16, halo=halo, tile_batch=1))
            assert abs(tiled[halo][i] - want) <= 1e-3
    assert halo_parity.main(["--device", "cpu", "--checkpoint", pth,
                             "--val_dir", str(val), "--tile_w", "16",
                             "--halos", "2,4"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^\[halo\] val_dir=.*: whole-frame psnr_rgb=[\d.]+ dB "
                     r"\(2 images, float32, lax\)$", out, re.M)
    assert len(re.findall(r"delta_vs_whole=[+-][\d.]+ dB$", out, re.M)) == 2


def _jax_make_dataset():
    """``make_dataset`` of the JAX ``tools/demo_train_eval.py``, compiled
    from the file's ``ast`` alone (its top level is not run)."""
    path = os.path.join(ROOT, "tools", "demo_train_eval.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "make_dataset")
    ns = {"np": np, "os": os}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["make_dataset"]


def test_demo_dataset_is_the_jax_tools(tmp_path):
    kw = dict(n_train=2, n_val=1, size=96, seed=4)
    demo_train_eval.make_dataset(str(tmp_path / "ours"), **kw)
    _jax_make_dataset()(str(tmp_path / "ref"), **kw)
    for split, names in (("train", ["im000.png", "im001.png"]),
                         ("val", ["im000.png"])):
        assert sorted(os.listdir(tmp_path / "ours" / split)) == names
        for n in names:
            with open(tmp_path / "ours" / split / n, "rb") as a, \
                    open(tmp_path / "ref" / split / n, "rb") as b:
                assert a.read() == b.read(), (split, n)


def test_demo_runs_and_prints_every_line(tmp_path, capsys):
    root = str(tmp_path / "demo")
    demo_train_eval.make_dataset(root, n_train=4, n_val=2, size=192)
    assert demo_train_eval.main(["--device", "cpu", "--steps", "2",
                                 "--gan_steps", "2", "--blocks", "1",
                                 "--batch", "2", "--out", root]) == 0
    out = capsys.readouterr().out
    for pattern in (
            r"\[demo\] training 2 steps \(1-block RRDBNet, batch 2 @192²\)",
            r"\[demo\] GAN phase: 2 steps",
            r"\[demo\] final eval on held-out images",
            r"\[demo\] HR ground-truth sharpness: [\d.]+",
            *(rf"\[demo\] {n:8s}: psnr_rgb=\S+ psnr_y=\S+ sharpness=\S+ "
              rf"ssim=\S+" for n in ("bicubic", "psnr", "gan", "gan_ema")),
            r"\[demo\] PSNR-model gain over bicubic: [+-][\d.]+ dB",
            r"\[demo\] GAN sharpness gain over PSNR model: [+-][\d.]+",
            r"\[demo\] comparison strips \(bicubic\|psnr\|gan\|gan_ema\|HR\)"):
        assert re.search(pattern, out), pattern
    assert len(os.listdir(os.path.join(root, "compare"))) == 2
    assert out.rstrip().splitlines()[-1].startswith("launches: ")
