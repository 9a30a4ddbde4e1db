"""Tests of the port that need the card: the dense-block CUDA kernels,
forward (NCHW and NHWC entries) and backward, the single-conv kernel,
the experiment variants v3–v6 routed to the dense-block kernel and the
int8 kernel of v8, against their plain versions, their launch counts and
input checks, the generator under every conv impl (lax included)
with either tail, the RRDB trunk on the chain bit for bit against the
same trunk block by block, SwinIR's window-attention and add-and-LayerNorm
kernels and its bf16 forward, a training step, the CLI, ``eval_batch``
and the headline bench on CUDA.  Marked
``cuda``; each skips where torch sees no CUDA device.  On a machine
with a card (no JAX needed there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: float32 atol 2e-5 + rtol 1e-5 (the same
arithmetic summed in another order), bfloat16 atol = rtol = 2**-6
(about two bf16 ULPs: a flipped rounding of one conv output carries
through the later convs of the block).  Backward, each tensor against
its own largest value: float32 1e-4 (sums over all pixels in another
order); bfloat16 dx 2**-6 like the forward, dW and db 2**-8 (one bf16
ULP of the largest entry: the cotangents are rounded to bf16 before the
products, and a rounding flipped by another summation order upstream
moves a sum over all pixels by far less than that).
"""

import importlib
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.config import GeneratorConfig
from super_resolution_tpu_torch.models import rrdb
from super_resolution_tpu_torch.ops.conv3x3 import (
    conv3x3,
    conv3x3_cf,
    conv3x3_cf_train,
    conv3x3_plain,
)
from super_resolution_tpu_torch.ops.dense_block import (
    BWD_LAUNCHES_PER_BLOCK,
    LAUNCHES_PER_BLOCK,
    bwd_launches,
    dense_block,
    dense_block_bwd,
    dense_block_plain,
    dense_block_train,
    fused_dense_block,
    fused_dense_block_plain,
    pack_weight,
    plain_backward,
    plain_forward,
)

pytestmark = pytest.mark.cuda

# the module: the package's ``ops`` exports a function of the same name
db_ops = importlib.import_module("super_resolution_tpu_torch.ops.dense_block")
c3_ops = importlib.import_module("super_resolution_tpu_torch.ops.conv3x3")
ex_ops = importlib.import_module(
    "super_resolution_tpu_torch.ops.experiments_dense_block")

TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2.0 ** -6, 2.0 ** -6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _block(shape, growth, dtype, device, seed=0, n=5):
    gen = torch.Generator().manual_seed(seed)
    b, c, h, w = shape
    x = torch.randn(shape, generator=gen).to(device, dtype)
    ws, bs, cin = [], [], c
    for k in range(n):
        cout = c if k == n - 1 else growth
        wk = torch.randn(cout, cin, 3, 3, generator=gen) \
            * math.sqrt(2.0 / (9 * cin))
        ws.append(pack_weight(wk).to(device, dtype))
        bs.append((torch.randn(cout, generator=gen) * 0.1).to(device))
        cin += growth
    return x, ws, bs


@pytest.mark.parametrize("shape,growth,dtype,slope", [
    ((2, 64, 32, 48), 32, torch.bfloat16, 0.2),
    ((1, 64, 37, 53), 32, torch.float32, 0.2),
    ((1, 64, 20, 24), 64, torch.bfloat16, 0.01),
    ((3, 16, 9, 70), 8, torch.float32, 0.2),
    ((1, 24, 17, 16), 16, torch.bfloat16, 0.2),
])
def test_kernel_matches_plain(cuda, shape, growth, dtype, slope):
    x, ws, bs = _block(shape, growth, dtype, cuda)
    before = dense_block.launches
    y = dense_block(x, ws, bs, res_scale=0.2, slope=slope)
    torch.cuda.synchronize()
    assert dense_block.launches == before + LAUNCHES_PER_BLOCK
    ref = dense_block_plain(x, ws, bs, res_scale=0.2, slope=slope)
    assert y.shape == ref.shape and y.dtype == ref.dtype
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=rtol)


def test_kernel_rejects_instead_of_falling_back(cuda):
    x, ws, bs = _block((1, 16, 8, 8), 8, torch.float32, cuda)
    before = dense_block.launches
    with pytest.raises(ValueError, match="contiguous"):
        dense_block(x.transpose(2, 3), ws, bs, res_scale=0.2, slope=0.2)
    with pytest.raises(ValueError, match="weights on cpu"):
        dense_block(x, [w.cpu() for w in ws], bs, res_scale=0.2, slope=0.2)
    assert dense_block.launches == before


BWD_TOL = {torch.float32: dict(dx=1e-4, dw=1e-4, db=1e-4),
           torch.bfloat16: dict(dx=2.0 ** -6, dw=2.0 ** -8, db=2.0 ** -8)}


def _rel(got, want):
    """max |got - want| over the largest |want|."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape,growth,dtype,slope", [
    ((4, 64, 48, 48), 32, torch.bfloat16, 0.2),
    ((1, 64, 37, 53), 32, torch.float32, 0.2),
    ((2, 64, 20, 24), 64, torch.bfloat16, 0.01),
    ((3, 16, 9, 70), 8, torch.float32, 0.2),
    ((4, 64, 48, 6), 32, torch.bfloat16, 0.2),
])
def test_backward_kernels_match_plain(cuda, shape, growth, dtype, slope):
    x, ws, bs = _block(shape, growth, dtype, cuda)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(9)) \
        .to(cuda, dtype)
    kw = dict(res_scale=0.2, slope=slope)
    _, feats = dense_block(x, ws, bs, save_acts=True, **kw)
    before = dense_block_bwd.launches
    dx, dws, dbs = dense_block_bwd(feats, ws, g, **kw)
    torch.cuda.synchronize()
    assert dense_block_bwd.launches == before + bwd_launches(5, dtype)
    rx, rws, rbs = plain_backward(feats, ws, g, **kw)
    assert dx.dtype == dtype and dx.shape == x.shape
    tol = BWD_TOL[dtype]
    assert _rel(dx, rx) <= tol["dx"]
    for k in range(5):
        assert dws[k].dtype == dbs[k].dtype == torch.float32
        assert dws[k].shape == ws[k].shape
        assert _rel(dws[k], rws[k]) <= tol["dw"], f"dW{k + 1}"
        assert _rel(dbs[k], rbs[k]) <= tol["db"], f"db{k + 1}"
    # the two-pass weight gradient has a fixed summation order
    dx2, dws2, dbs2 = dense_block_bwd(feats, ws, g, **kw)
    assert torch.equal(dx, dx2)
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("n,c,growth", [(4, 8, 4), (5, 16, 4), (3, 8, 8),
                                        (5, 12, 6), (5, 96, 72)],
                         ids=["n4_c8_g4", "n5_c16_g4", "n3_c8_g8",
                              "n5_c12_g6", "n5_c96_g72"])
def test_any_conv_count_and_width(cuda, n, c, growth, dtype):
    """The full calling contract on the card: forward (NCHW and NHWC)
    and backward at any conv count and width, against the plain
    versions, launches by their formulas, two backward runs bit for
    bit."""
    x, ws, bs = _block((2, c, 21, 37), growth, dtype, cuda, n=n)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(8)) \
        .to(cuda, dtype)
    kw = dict(res_scale=0.2, slope=0.2)
    f0, b0 = dense_block.launches, dense_block_bwd.launches
    y, feats = dense_block(x, ws, bs, save_acts=True, **kw)
    y_nhwc = fused_dense_block(x.permute(0, 2, 3, 1).contiguous(), ws, bs,
                               **kw)
    dx, dws, dbs = dense_block_bwd(feats, ws, g, **kw)
    torch.cuda.synchronize()
    assert dense_block.launches - f0 == n
    assert dense_block_bwd.launches - b0 == bwd_launches(n, dtype)
    ref = dense_block_plain(x, ws, bs, **kw)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(y_nhwc.permute(0, 3, 1, 2).float(),
                               ref.float(), atol=atol, rtol=rtol)
    rx, rws, rbs = plain_backward(feats, ws, g, **kw)
    tol = BWD_TOL[dtype]
    assert _rel(dx, rx) <= tol["dx"]
    for k in range(n):
        assert dws[k].shape == ws[k].shape
        assert _rel(dws[k], rws[k]) <= tol["dw"], f"dW{k + 1}"
        assert _rel(dbs[k], rbs[k]) <= tol["db"], f"db{k + 1}"
    dx2, dws2, dbs2 = dense_block_bwd(feats, ws, g, **kw)
    assert torch.equal(dx, dx2)
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))


def test_train_function_launches_both_kernels(cuda):
    """autograd through dense_block_train on the card: five forward and
    eight backward launches, dW in the weights' dtype, a non-contiguous
    cotangent made contiguous."""
    x, ws, bs = _block((2, 64, 24, 40), 32, torch.bfloat16, cuda)
    leaves = [t.requires_grad_(True) for t in (x, *ws, *bs)]
    fwd0, bwd0 = dense_block.launches, dense_block_bwd.launches
    y = dense_block_train(x, ws, bs, res_scale=0.2, slope=0.2)
    g = torch.randn(2, 64, 40, 24, generator=torch.Generator()
                    .manual_seed(3)).to(cuda, torch.bfloat16).transpose(2, 3)
    assert not g.is_contiguous()
    grads = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert dense_block.launches - fwd0 == LAUNCHES_PER_BLOCK
    assert dense_block_bwd.launches - bwd0 == BWD_LAUNCHES_PER_BLOCK
    assert all(gr.dtype == t.dtype and gr.shape == t.shape
               for gr, t in zip(grads, leaves))
    _, feats = plain_forward(x.detach(), [w.detach() for w in ws],
                             [b.detach() for b in bs], res_scale=0.2,
                             slope=0.2, save_acts=True)
    rx, rws, _ = plain_backward(feats, [w.detach() for w in ws],
                                g.contiguous(), res_scale=0.2, slope=0.2)
    assert _rel(grads[0], rx) <= 2.0 ** -6
    assert _rel(grads[5], rws[4].to(torch.bfloat16)) <= 2.0 ** -7


def test_backward_rejects_instead_of_falling_back(cuda):
    x, ws, bs = _block((1, 16, 8, 8), 8, torch.float32, cuda)
    _, feats = dense_block(x, ws, bs, res_scale=0.2, slope=0.2,
                           save_acts=True)
    g = torch.ones_like(x)
    before = dense_block_bwd.launches
    kw = dict(res_scale=0.2, slope=0.2)
    with pytest.raises(ValueError, match="contiguous"):
        dense_block_bwd(feats, ws, g.transpose(2, 3), **kw)   # 8 x 8
    with pytest.raises(TypeError, match="cotangent"):
        dense_block_bwd(feats, ws, g.cpu(), **kw)
    with pytest.raises(ValueError, match="feature buffer"):
        dense_block_bwd(feats[..., :-8], ws, g, **kw)
    assert dense_block_bwd.launches == before


def test_failed_build_raises(cuda, monkeypatch):
    """No fallback when the kernels cannot be built or loaded."""
    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr("super_resolution_tpu_torch.build.load", broken)
    x, ws, bs = _block((1, 16, 8, 8), 8, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        dense_block(x, ws, bs, res_scale=0.2, slope=0.2)
    feats = torch.zeros(1, 8, 8, 48, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        dense_block_bwd(feats, ws, torch.ones_like(x), res_scale=0.2,
                        slope=0.2)


def test_training_step_on_the_card_matches_plain(cuda, monkeypatch):
    """One float32 GAN step of a small model through the kernels against
    the same step through the plain dense block: every loss and every
    gradient tensor of G."""
    from super_resolution_tpu_torch import config as C
    from super_resolution_tpu_torch.train.state import init_state
    from super_resolution_tpu_torch.train.steps import make_gan_step

    cfg = C.TrainConfig(
        generator=C.GeneratorConfig(filters=32, growth=16, n_blocks=2,
                                    init="torch_default"),
        discriminator=C.DiscriminatorConfig(base_filters=8, n_scales=2),
        loss=C.LossConfig(perceptual_source="d_features"),
        data=C.DataConfig(hr_patch=48, batch_size=2),
        compute_dtype="float32")
    gen = torch.Generator().manual_seed(4)
    lr = torch.randn(2, 12, 12, 3, generator=gen).to(cuda)
    hr = torch.randn(2, 48, 48, 3, generator=gen).to(cuda)
    out = {}
    for which in ("kernel", "plain"):
        if which == "plain":
            monkeypatch.setattr(db_ops, "dense_block", plain_forward)
            monkeypatch.setattr(db_ops, "dense_block_bwd", plain_backward)
        state = init_state(cfg, cuda)
        fwd0, bwd0 = dense_block.launches, dense_block_bwd.launches
        metrics = make_gan_step(cfg).core(state, lr, hr)
        out[which] = (metrics, {n: p.grad.clone()
                                for n, p in state.g.named_parameters()},
                      dense_block.launches - fwd0,
                      dense_block_bwd.launches - bwd0)
    n_blocks = cfg.generator.n_blocks * cfg.generator.n_dense
    assert out["kernel"][2:] == (n_blocks * LAUNCHES_PER_BLOCK,
                                 n_blocks * bwd_launches(5, torch.float32))
    assert out["plain"][2:] == (0, 0)
    for name, want in out["plain"][0].items():
        torch.testing.assert_close(out["kernel"][0][name], want, atol=1e-5,
                                   rtol=1e-4, msg=name)
    for name, want in out["plain"][1].items():
        assert _rel(out["kernel"][1][name], want) <= 1e-4, name


def test_generator_kernel_matches_plain_forward(cuda, monkeypatch):
    cfg = GeneratorConfig(n_blocks=2, filters=32, growth=16)
    model = rrdb.RRDBNet(cfg, torch.Generator().manual_seed(1)).to(cuda)
    model.prepare(torch.float32)
    x = torch.randn(2, 24, 40, 3, generator=torch.Generator()
                    .manual_seed(2)).to(cuda)
    with torch.inference_mode():
        before = dense_block.launches
        got = model(x)
        assert dense_block.launches - before == \
            cfg.n_blocks * cfg.n_dense * LAUNCHES_PER_BLOCK
        monkeypatch.setattr(rrdb, "dense_block", dense_block_plain)
        ref = model(x)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_cli_on_the_card_matches_the_cpu(cuda, tmp_path):
    from torch_spec import RRDBNetTorch

    torch.manual_seed(0)
    pth = str(tmp_path / "g.pth")
    torch.save(RRDBNetTorch(nf=16, nb=1, gc=8).state_dict(), pth)
    rng = np.random.default_rng(0)
    src = str(tmp_path / "lr.png")
    Image.fromarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)) \
        .save(src)
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = str(tmp_path / f"{dev}.png")
        assert main(["upscale", "--image", src, "--checkpoint", pth,
                     "--out", outs[dev], "--dtype", "float32", "--tile",
                     "32", "--halo", "6", "--device", dev]) == 0
    with Image.open(outs["cuda"]) as a, Image.open(outs["cpu"]) as b:
        got, ref = np.asarray(a).astype(int), np.asarray(b).astype(int)
    assert got.shape == ref.shape == (160, 208, 3)
    assert np.abs(got - ref).max() <= 1
    assert os.path.getsize(outs["cuda"]) > 0


def _conv(shape, cout, dtype, device, seed=0):
    """NHWC x, packed weights, f32 bias of one conv on the card."""
    gen = torch.Generator().manual_seed(seed)
    cin = shape[-1]
    x = torch.randn(shape, generator=gen).to(device, dtype)
    w = torch.randn(cout, cin, 3, 3, generator=gen) \
        * math.sqrt(2.0 / (9 * cin))
    b = (torch.randn(cout, generator=gen) * 0.1).to(device)
    return x, pack_weight(w).to(device, dtype), b


@pytest.mark.parametrize("shape,cout,dtype,act,out_dtype", [
    ((2, 40, 52, 64), 64, torch.bfloat16, True, None),     # tail conv
    ((2, 24, 40, 64), 3, torch.bfloat16, False, None),     # conv_last
    ((2, 24, 40, 3), 64, torch.bfloat16, False, None),     # conv_first
    ((1, 20, 36, 64), 256, torch.bfloat16, True, None),    # pixelshuffle up
    ((1, 37, 53, 64), 64, torch.float32, True, None),      # odd, fp32
    ((2, 19, 21, 3), 64, torch.float32, False, None),      # fp32 cin 3
    ((1, 37, 53, 64), 3, torch.float32, False, None),      # fp32 cout 3
    ((1, 18, 30, 32), 16, torch.bfloat16, True, torch.float32),
    # the bf16 tile's load path: H, W not multiples of 16, a plane
    # smaller than one tile, five K chunks with resident weights, weights
    # streamed with the ring, two 128-channel groups of the upconv
    ((2, 37, 53, 64), 64, torch.bfloat16, True, None),
    ((1, 7, 9, 64), 32, torch.bfloat16, False, None),
    ((2, 33, 17, 160), 32, torch.bfloat16, True, None),
    ((1, 29, 45, 192), 64, torch.bfloat16, False, None),
    ((2, 40, 48, 64), 256, torch.bfloat16, True, None),
    ((1, 35, 30, 3), 64, torch.bfloat16, False, None),
    ((1, 31, 50, 64), 3, torch.bfloat16, False, None),
])
def test_conv3x3_kernel_matches_plain(cuda, shape, cout, dtype, act,
                                      out_dtype):
    x, w, b = _conv(shape, cout, dtype, cuda)
    before = conv3x3.launches
    y = conv3x3(x, w, b, act=act, slope=0.2, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    ref = conv3x3_plain(x, w, b, act=act, slope=0.2, out_dtype=out_dtype)
    assert y.shape == ref.shape == (*shape[:3], cout)
    assert y.dtype == ref.dtype
    # one rounding of the same f32 sum: bf16 one ULP, f32 summation order
    atol, rtol = ((2e-5, 1e-5) if y.dtype == torch.float32
                  else (2.0 ** -8, 2.0 ** -7))
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3x3_reads_a_prefix_and_writes_a_slice(cuda, dtype):
    """A dense-block conv under conv_impl='pallas': the channel prefix of
    one channels-last buffer in, the next channel slice of it out."""
    buf = torch.randn(2, 24, 40, 96, generator=torch.Generator()
                      .manual_seed(1)).to(cuda, dtype)
    _, w, b = _conv((1, 1, 1, 64), 32, dtype, cuda, seed=2)
    want = conv3x3_plain(buf[..., :64], w, b, act=False, slope=0.2)
    keep = buf.clone()
    got = conv3x3(buf[..., :64], w, b, act=False, slope=0.2,
                  out=buf[..., 64:])
    torch.cuda.synchronize()
    assert got.data_ptr() == buf.data_ptr() + 64 * buf.element_size()
    assert torch.equal(buf[..., :64], keep[..., :64])
    atol = 2e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(buf[..., 64:].float(), want.float(),
                               atol=atol, rtol=2.0 ** -7)


def test_conv3x3_cf_converts_only_contiguous_nchw(cuda):
    x, w, b = _conv((2, 20, 28, 64), 64, torch.bfloat16, cuda)
    nchw = x.permute(0, 3, 1, 2)                 # channels-last storage
    conv0 = conv3x3_cf.conversions
    y = conv3x3_cf(nchw, w, b, act=True)
    assert conv3x3_cf.conversions == conv0
    y2 = conv3x3_cf(nchw.contiguous(), w, b, act=True)
    assert conv3x3_cf.conversions == conv0 + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, y2)
    ref = conv3x3_plain(x, w, b, act=True, slope=0.2).permute(0, 3, 1, 2)
    torch.testing.assert_close(y.float(), ref.float(), atol=2.0 ** -8,
                               rtol=2.0 ** -7)


def test_conv3x3_cf_train_grads_match_the_cpu(cuda):
    """The training conv on the card against the same Function on the CPU
    (plain forward, PyTorch's convolution backward), float32."""
    x, w, b = _conv((2, 18, 22, 16), 32, torch.float32, "cpu", seed=3)
    nchw = x.permute(0, 3, 1, 2).contiguous()
    g = torch.randn(2, 32, 18, 22, generator=torch.Generator().manual_seed(4))
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True) for t in (nchw, w, b)]
        before = conv3x3.launches
        y = conv3x3_cf_train(*leaves, act=True, slope=0.2)
        assert conv3x3.launches - before == (dev != "cpu")
        grads[str(dev)] = [t.cpu() for t in
                           torch.autograd.grad(y, leaves, g.to(dev))]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("shape,growth,dtype", [
    ((2, 32, 48, 64), 32, torch.bfloat16),
    ((1, 37, 53, 64), 32, torch.float32),
    ((3, 9, 70, 16), 8, torch.bfloat16),
])
def test_nhwc_entry_matches_plain(cuda, shape, growth, dtype):
    x, ws, bs = _block((shape[0], shape[3], shape[1], shape[2]), growth,
                       dtype, cuda)
    x = x.permute(0, 2, 3, 1).contiguous()
    nchw0, nhwc0 = dense_block.launches, fused_dense_block.launches
    y = fused_dense_block(x, ws, bs, res_scale=0.2, slope=0.2)
    torch.cuda.synchronize()
    assert fused_dense_block.launches == nhwc0 + LAUNCHES_PER_BLOCK
    assert dense_block.launches == nchw0
    ref = fused_dense_block_plain(x, ws, bs, res_scale=0.2, slope=0.2)
    assert y.shape == ref.shape == x.shape and y.is_contiguous()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=rtol)
    # the NCHW entry gives the same numbers
    y_cf = dense_block(x.permute(0, 3, 1, 2).contiguous(), ws, bs,
                       res_scale=0.2, slope=0.2)
    assert torch.equal(y, y_cf.permute(0, 2, 3, 1))


def _through_plain(monkeypatch):
    monkeypatch.setattr(rrdb, "dense_block", dense_block_plain)
    monkeypatch.setattr(rrdb, "fused_dense_block", fused_dense_block_plain)
    monkeypatch.setattr(c3_ops, "conv3x3", conv3x3_plain)


@pytest.mark.parametrize("impl,upsampler", [
    ("pallas_cf_tail", "nearest_conv"), ("pallas_cf_tail", "pixelshuffle"),
    ("pallas", "nearest_conv"), ("pallas_fused", "nearest_conv")])
def test_generator_impls_match_plain_forward(cuda, monkeypatch, impl,
                                             upsampler):
    cfg = GeneratorConfig(n_blocks=2, filters=32, growth=16, conv_impl=impl,
                          upsampler=upsampler, init="torch_default")
    model = rrdb.RRDBNet(cfg, torch.Generator().manual_seed(1)).to(cuda)
    model.prepare(torch.float32)
    x = torch.randn(2, 24, 40, 3, generator=torch.Generator()
                    .manual_seed(2)).to(cuda)
    n_blocks = cfg.n_blocks * cfg.n_dense
    counters = (dense_block, fused_dense_block, conv3x3)
    with torch.inference_mode():
        before = [f.launches for f in counters]
        got = model(x)
        counts = [f.launches - b for f, b in zip(counters, before)]
        _through_plain(monkeypatch)
        ref = model(x)
    want = {"pallas_cf_tail": [n_blocks * LAUNCHES_PER_BLOCK, 0, 4],
            "pallas": [0, 0, n_blocks * LAUNCHES_PER_BLOCK + 6],
            "pallas_fused": [0, n_blocks * LAUNCHES_PER_BLOCK, 0]}[impl]
    assert counts == want
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def _hwio_block(shape, growth, dtype, device, seed=0):
    """x and HWIO weights / f32 biases (the experiment kernels' contract)."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=gen).to(device, dtype)
    ws, bs, cin = [], [], c
    for k in range(5):
        cout = c if k == 4 else growth
        ws.append((torch.randn(3, 3, cin, cout, generator=gen)
                   * math.sqrt(2.0 / (9 * cin))).to(device, dtype))
        bs.append((torch.randn(cout, generator=gen) * 0.1).to(device))
        cin += growth
    return x, ws, bs


@pytest.mark.parametrize("name,kw", [
    ("fused_dense_block_cf", {}), ("fused_dense_block_cf2", {}),
    ("fused_dense_block_cf3", {}), ("fused_dense_block_cf3",
                                    {"save_acts": True}),
    ("fused_dense_block_cf6", {})],
    ids=["cf", "cf2", "cf3", "cf3_save_acts", "cf6"])
def test_routed_experiments_launch_the_block_kernel(cuda, name, kw):
    """v3–v6 route to csrc/dense_block.cu: five launches per call on
    their own counter, the plain version's values."""
    fn = getattr(ex_ops, name)
    x, ws, bs = _hwio_block((2, 32, 64, 40), 16, torch.bfloat16, cuda)
    before = (fn.launches, dense_block.launches)
    with torch.inference_mode():
        got = fn(x, ws, bs, **kw)
        torch.cuda.synchronize()
        assert (fn.launches - before[0], dense_block.launches - before[1]) \
            == (LAUNCHES_PER_BLOCK, 0)
        ref = fn(x.cpu(), [w.cpu() for w in ws], [b.cpu() for b in bs],
                 **kw)
    if kw:
        (got, acts), (ref, ref_acts) = got, ref
        for a, r in zip(acts, ref_acts):
            torch.testing.assert_close(a.cpu().float(), r.float(),
                                       atol=2.0 ** -6, rtol=2.0 ** -6)
    torch.testing.assert_close(got.cpu().float(), ref.float(),
                               atol=2.0 ** -6, rtol=2.0 ** -6)


@pytest.mark.parametrize("shape,growth,dtype,rows", [
    ((2, 64, 64, 48), 32, torch.bfloat16, 16),
    ((1, 16, 40, 37), 8, torch.float32, 8),
    ((1, 24, 30, 20), 16, torch.bfloat16, 10),
    # conv outputs of 72 and 96 channels: two output-channel groups of
    # 64 each; the least band height
    ((1, 96, 20, 21), 72, torch.bfloat16, 5),
    ((1, 96, 10, 19), 72, torch.float32, 5),
])
def test_int8_kernel_matches_plain(cuda, shape, growth, dtype, rows):
    """The int8 kernel against its plain version on the card: the same
    integers and the same f32 steps, so equal up to an ULP of x's dtype
    (a flipped quantization would move values by ~1e-3 of |y|)."""
    fn = ex_ops.fused_dense_block_cf8
    x, ws, bs = _hwio_block(shape, growth, dtype, cuda, seed=3)
    before = fn.launches
    with torch.inference_mode():
        got = fn(x, ws, bs, rows=rows)
        torch.cuda.synchronize()
        assert fn.launches - before == ex_ops.int8_launches(len(ws)) \
            == ex_ops.INT8_LAUNCHES_PER_CALL
        ref = ex_ops.fused_dense_block_cf8_plain(x, ws, bs, rows=rows)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= ulp * ref.float().abs().clamp_min(1e-30)).all()) \
        or diff.max().item() == 0.0


@pytest.mark.parametrize("n,c,growth,dtype", [
    (5, 64, 32, torch.bfloat16), (4, 12, 6, torch.float32),
    (5, 96, 72, torch.bfloat16)], ids=["flagship", "n4_c12_g6", "c96_g72"])
def test_int8_prep_and_band_match_plain(cuda, n, c, growth, dtype):
    """The weight-prep and banding launches against their plain versions
    element for element: every conv's int8 weights, scales and biases;
    the buffer's slice 0 and amax slice 0 (float bits), the other amax
    slices zeroed."""
    from super_resolution_tpu_torch.ops.dense_block import layout

    gen = torch.Generator().manual_seed(8)
    rows, (b, h, w) = 8, (2, 16, 21)
    x = torch.randn(b, c, h, w, generator=gen).to(cuda, dtype)
    ws, bs, cin = [], [], c
    for k in range(n):
        cout = c if k == n - 1 else growth
        # even convs: HWIO views of OIHW weights, read through strides
        w_ = (torch.randn(3, 3, cin, cout, generator=gen) if k % 2 else
              torch.randn(cout, cin, 3, 3, generator=gen).permute(2, 3, 1, 0))
        ws.append((w_ * 0.1).to(cuda, dtype))
        bs.append((torch.randn(cout, generator=gen) * 0.1).to(cuda))
        cin += growth
    ws[1][..., 0] = 0                        # an all-zero row: scale 1e-12/127
    lay = layout(c, growth, n, torch.bfloat16)
    n_bb, band_rows = b * (h // rows), rows + 2 * n
    plan = ex_ops.int8_scratch(lay, n_bb, band_rows)
    counter = type("Counter", (), {"launches": 0})
    with torch.inference_mode():
        scratch = torch.full((plan.nbytes,), 0x5A, dtype=torch.uint8,
                             device=cuda)
        buf = torch.full((n_bb, band_rows, w, lay.c_total), float("nan"),
                         dtype=dtype, device=cuda)
        ex_ops.int8_prep(counter, ws, bs, lay, scratch, plan)
        ex_ops.int8_band(counter, x, rows, lay, buf, scratch)
        torch.cuda.synchronize()
    assert counter.launches == 2
    want = ex_ops.prep_weights_plain([w_.cpu() for w_ in ws],
                                     [b_.cpu() for b_ in bs], lay)
    raw = scratch.cpu()
    for conv, (wq, sw, bias) in zip(plan.convs, want):
        got_wq = raw[conv.wq_off:conv.wq_off + wq.numel()].view(torch.int8)
        assert torch.equal(got_wq.reshape(wq.shape), wq)
        got_sw = raw[conv.sw_off:conv.sw_off + 4 * sw.numel()] \
            .view(torch.float32)
        assert torch.equal(got_sw, sw)
        got_b = raw[conv.bias_off:conv.bias_off + 4 * bias.numel()] \
            .view(torch.float32)
        assert torch.equal(got_b, bias)
    want_buf, want_amax = ex_ops.band_plain(x.cpu(), rows, lay)
    assert torch.equal(buf[..., :lay.cp].cpu(), want_buf)
    amax = raw[:4 * plan.amax_words].view(torch.int32) \
        .reshape(n, n_bb, band_rows)
    assert torch.equal(amax[0].view(torch.float32), want_amax)
    assert not amax[1:].any()


@pytest.mark.parametrize("n,c,growth,shape,dtype", [
    (1, 12, 0, (2, 12, 10, 13), torch.bfloat16),
    (2, 16, 8, (1, 16, 12, 7), torch.float32),
    (3, 8, 24, (1, 8, 18, 40), torch.bfloat16),
], ids=["n1_w13", "n2_w7_fp32", "n3_g24"])
def test_int8_any_conv_count_matches_plain(cuda, n, c, growth, shape,
                                           dtype):
    """Conv counts other than five, widths below and not a multiple of
    the 16-column tile, on the card: n + 2 launches, the plain version's
    values up to an ULP of x's dtype."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(shape, generator=gen).to(cuda, dtype)
    ws, bs, cin = [], [], c
    for k in range(n):
        cout = c if k == n - 1 else growth
        ws.append((torch.randn(3, 3, cin, cout, generator=gen)
                   * math.sqrt(2.0 / (9 * cin))).to(cuda, dtype))
        bs.append((torch.randn(cout, generator=gen) * 0.1).to(cuda))
        cin += growth
    fn = ex_ops.fused_dense_block_cf8
    rows = 5 if shape[2] % 6 else 6
    before = fn.launches
    with torch.inference_mode():
        got = fn(x, ws, bs, rows=rows)
        torch.cuda.synchronize()
        assert fn.launches - before == ex_ops.int8_launches(n) == n + 2
        ref = ex_ops.fused_dense_block_cf8_plain(x, ws, bs, rows=rows)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= ulp * ref.float().abs()).all())


def test_int8_kernel_depends_on_rows(cuda):
    x, ws, bs = _hwio_block((1, 32, 64, 40), 16, torch.bfloat16, cuda,
                            seed=4)
    with torch.inference_mode():
        y16 = ex_ops.fused_dense_block_cf8(x, ws, bs, rows=16)
        y32 = ex_ops.fused_dense_block_cf8(x, ws, bs, rows=32)
    assert not torch.equal(y16, y32)


def test_lax_generator_on_the_card_matches_the_cpu(cuda):
    """conv_impl lax: cuDNN on the card, no kernel of the port, float32
    (TF32 off) against the CPU."""
    cfg = GeneratorConfig(n_blocks=2, filters=32, growth=16,
                          conv_impl="lax", init="torch_default")
    model = rrdb.RRDBNet(cfg, torch.Generator().manual_seed(1))
    x = torch.randn(2, 24, 40, 3, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        ref = model.prepare(torch.float32)(x)
        counters = (dense_block, fused_dense_block, conv3x3)
        before = [f.launches for f in counters]
        got = model.to(cuda).prepare(torch.float32)(x.to(cuda))
        assert [f.launches for f in counters] == before
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


# The bf16 forward's Hopper tile (csrc/conv3x3_wgmma.cuh) loads by TMA:
# its tensor maps, not predicates, give the SAME padding, the cut at cin
# and the ragged edge of a plane.

@pytest.mark.parametrize("shape,growth,nhwc", [
    ((2, 64, 37, 53), 32, False),
    ((1, 64, 21, 19), 32, True),
    ((1, 16, 23, 40), 8, False),
])
def test_block_reads_nothing_past_cin(cuda, shape, growth, nhwc):
    """Every channel from a conv's cin upward (and so every slice not yet
    written) is NaN before its launch: a read past cin would make y NaN."""
    x, ws, bs = _block(shape, growth, torch.bfloat16, cuda, seed=5)
    xin = x.permute(0, 2, 3, 1).contiguous() if nhwc else x
    counter = type("Counter", (), {"launches": 0})
    y, buf = db_ops._launch_block(counter, xin, x.permute(0, 2, 3, 1),
                                  ws, bs, 0.2, 0.2, nhwc=nhwc, poison=True)
    torch.cuda.synchronize()
    assert counter.launches == LAUNCHES_PER_BLOCK
    assert bool(torch.isfinite(buf.float()).all())
    ref = dense_block_plain(x, ws, bs, res_scale=0.2, slope=0.2)
    if nhwc:
        ref = ref.permute(0, 2, 3, 1)
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=rtol)


def test_conv3x3_prefix_of_one_buffer_into_a_slice_of_another(cuda):
    """Channels [0, 64) of a 96-channel buffer in, channels [40, 72) of a
    128-channel buffer out: both neighbours of the slice bit for bit as
    they were, the input buffer untouched."""
    gen = torch.Generator().manual_seed(6)
    src = torch.randn(2, 21, 35, 96, generator=gen).to(cuda, torch.bfloat16)
    dst = torch.randn(2, 21, 35, 128, generator=gen).to(cuda, torch.bfloat16)
    _, w, b = _conv((1, 1, 1, 64), 32, torch.bfloat16, cuda, seed=7)
    src0, dst0 = src.clone(), dst.clone()
    conv3x3(src[..., :64], w, b, act=True, slope=0.2, out=dst[..., 40:72])
    torch.cuda.synchronize()
    assert torch.equal(src, src0)
    assert torch.equal(dst[..., :40], dst0[..., :40])
    assert torch.equal(dst[..., 72:], dst0[..., 72:])
    want = conv3x3_plain(src[..., :64], w, b, act=True, slope=0.2)
    torch.testing.assert_close(dst[..., 40:72].float(), want.float(),
                               atol=2.0 ** -8, rtol=2.0 ** -7)


# Eval on the card: the metrics with TF32 off, and evaluate_directory
# through the dense-block kernel against the CPU.

def test_metrics_on_the_card_match_the_cpu(cuda):
    from super_resolution_tpu_torch.metrics import eval_metrics

    rng = np.random.default_rng(8)
    a = rng.random((2, 48, 56, 3), dtype=np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    ref = eval_metrics(torch.from_numpy(a), torch.from_numpy(b))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # cuDNN's default
    try:
        got = eval_metrics(torch.from_numpy(a).to(cuda),
                           torch.from_numpy(b).to(cuda))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for k, v in ref.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5, k


def test_evaluate_directory_on_the_card_matches_the_cpu(cuda, tmp_path):
    import dataclasses

    from super_resolution_tpu_torch.config import TrainConfig
    from super_resolution_tpu_torch.train.evaluate import evaluate_directory

    gcfg = GeneratorConfig(n_blocks=1, filters=16, growth=8,
                           init="torch_default")
    sd = rrdb.RRDBNet(gcfg, torch.Generator().manual_seed(9)).state_dict()
    cfg = dataclasses.replace(TrainConfig(), generator=gcfg,
                              compute_dtype="float32")
    rng = np.random.default_rng(9)
    for i, (h, w) in enumerate(((64, 64), (48, 60))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(tmp_path / f"{i}.png")
    kw = dict(tile=8, halo=2, tile_batch=4)
    ref = evaluate_directory(cfg, sd, str(tmp_path), device="cpu", **kw)
    before = dense_block.launches
    got = evaluate_directory(cfg, sd, str(tmp_path), device="cuda", **kw)
    assert dense_block.launches > before
    assert got["n_images"] == ref["n_images"] == 2
    for k in ("psnr_rgb", "psnr_y"):
        assert abs(got[k] - ref[k]) <= 1e-3, k
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-5


@pytest.mark.parametrize("impl", ["auto", "pallas_cf_tail", "pallas",
                                  "pallas_fused", "lax"])
def test_polyphase_tail_on_the_card(cuda, impl):
    """``tail_up="polyphase"``: the upconvs leave the single-conv kernel
    (2 tail launches under pallas_cf_tail, 2 fewer under pallas), and
    the forward equals the naive tail's with the same weights (float32,
    TF32 off)."""
    x = torch.randn(2, 24, 40, 3, generator=torch.Generator()
                    .manual_seed(2)).to(cuda)
    sd = rrdb.RRDBNet(GeneratorConfig(n_blocks=2, filters=32, growth=16,
                                      init="torch_default"),
                      torch.Generator().manual_seed(1)).state_dict()
    outs = {}
    for tail in ("naive", "polyphase"):
        model = rrdb.RRDBNet(GeneratorConfig(
            n_blocks=2, filters=32, growth=16, conv_impl=impl,
            init="torch_default", tail_up=tail))
        model.load_state_dict(sd)
        model.to(cuda).prepare(torch.float32)
        with torch.inference_mode():
            before = conv3x3.launches
            outs[tail] = model(x)
            launches = conv3x3.launches - before
    n_blocks = 2 * 3
    want = {"pallas_cf_tail": 2,
            "pallas": n_blocks * LAUNCHES_PER_BLOCK + 4}.get(impl, 0)
    assert launches == want
    torch.testing.assert_close(outs["polyphase"], outs["naive"], atol=2e-5,
                               rtol=1e-5)


# The last of the JAX package's surface on the card: eval_batch through
# the dense-block kernel against the CPU, and the headline bench.

def test_eval_batch_on_the_card_matches_the_cpu(cuda):
    from super_resolution_tpu_torch.config import TrainConfig
    from super_resolution_tpu_torch.train.steps import eval_batch

    gcfg = GeneratorConfig(n_blocks=2, filters=32, growth=16,
                           init="torch_default")
    sd = rrdb.RRDBNet(gcfg, torch.Generator().manual_seed(3)).state_dict()
    cfg = TrainConfig(generator=gcfg, compute_dtype="float32")
    hr = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)
    ref = eval_batch(cfg, sd, hr, device="cpu")["psnr"]
    before = dense_block.launches
    got = eval_batch(cfg, sd, hr, device=cuda)["psnr"]
    assert got.device.type == "cuda"
    assert dense_block.launches - before == 2 * 3 * LAUNCHES_PER_BLOCK
    assert abs(float(got) - float(ref)) <= 1e-3


def test_bench_runs_through_the_kernel(cuda, capsys):
    from super_resolution_tpu_torch import bench

    gcfg = GeneratorConfig(n_blocks=2, init=bench.SEED_INIT,
                           conv_impl="pallas_cf")
    res = bench.run(gcfg, batch=2, tile=32, iters=2, device=cuda)
    line = json.loads(capsys.readouterr().out.strip())
    assert line == res["result"]
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert res["launches"] == {"dense_block": res["forwards"] * 2 * 3
                               * LAUNCHES_PER_BLOCK}


# The RRDB trunk on the chain: three feature buffers, each block's last
# launch writing the next block's input (and the RRDB's residual), held
# bit for bit to the same trunk block by block.

def _chain_trunks(cuda, shape, seed=0, **kw):
    """(chained trunk, per-block trunk, the chain's counters) of a bf16
    RRDBNet (torch_default weights: values of order 1) on a seeded
    feature map."""
    from super_resolution_tpu_torch.metrics import recording, span_report

    cfg = GeneratorConfig(init="torch_default", **kw)
    model = rrdb.RRDBNet(cfg, torch.Generator().manual_seed(seed)).to(cuda)
    model.prepare(torch.bfloat16)
    fea = torch.randn(shape, generator=torch.Generator().manual_seed(
        seed + 1)).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        ref = model.body(fea)
        with recording():
            got = model.trunk(fea)
            torch.cuda.synchronize()
            counters = span_report()["counters"]
    return got, ref, counters


@pytest.mark.parametrize("n_blocks,shape", [
    (23, (2, 64, 384, 384)), (23, (2, 64, 300, 384)),
    (6, (1, 64, 256, 256))], ids=["cli_tile", "cli_tile_short", "anime6b"])
def test_chained_trunk_is_the_per_block_trunk_bit_for_bit(cuda, n_blocks,
                                                          shape):
    got, ref, counters = _chain_trunks(cuda, shape, n_blocks=n_blocks)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, ref)
    n = n_blocks * 3
    assert counters["launches.dense_block"] == n * LAUNCHES_PER_BLOCK
    assert counters["dense_block.chained"] == n - 1
    assert counters["dense_block.input_copies"] == 1


@pytest.mark.parametrize("kw,shape", [
    # padded widths (C 12 -> 16, G 6 -> 8); W not a multiple of 8: the
    # element-wise chain and NCHW stores
    (dict(filters=12, growth=6, n_dense_convs=3), (2, 12, 37, 53)),
    # one block per RRDB: its output cannot take x_o's place
    (dict(filters=32, growth=16, n_dense=1), (1, 32, 24, 40)),
    (dict(filters=32, growth=16, n_dense=2, n_dense_convs=4),
     (2, 32, 20, 16)),
    # channels above one group of 64 outputs
    (dict(filters=96, growth=32), (1, 96, 16, 24))],
    ids=["padded_odd_w", "one_block", "two_blocks", "wide"])
def test_chained_trunk_geometries(cuda, kw, shape):
    got, ref, counters = _chain_trunks(cuda, shape, n_blocks=3, **kw)
    assert torch.equal(got, ref)
    n = 3 * kw.get("n_dense", 3)
    assert counters["dense_block.chained"] == n - 1
    assert counters["launches.dense_block"] == \
        n * kw.get("n_dense_convs", 5)


def test_generator_forward_through_the_chain(cuda, monkeypatch):
    """The whole bf16 forward: the chain (auto and pallas_cf_tail) gives
    the per-block path's output bit for bit; float32 keeps the per-block
    path."""
    x = torch.randn(2, 24, 40, 3, generator=torch.Generator()
                    .manual_seed(5)).to(cuda)
    for impl in ("auto", "pallas_cf_tail"):
        cfg = GeneratorConfig(n_blocks=2, filters=32, growth=16,
                              conv_impl=impl, init="torch_default")
        model = rrdb.RRDBNet(cfg, torch.Generator().manual_seed(1)).to(cuda)
        model.prepare(torch.bfloat16)
        with torch.inference_mode():
            got = model(x)
            # another function in dense_block's place: block by block
            monkeypatch.setattr(rrdb, "dense_block",
                                lambda *a, **k: dense_block(*a, **k))
            ref = model(x)
            monkeypatch.undo()
        assert torch.equal(got, ref), impl
    model.prepare(torch.float32)
    with torch.inference_mode():
        before = dense_block.launches
        model(x)
    assert dense_block.launches - before == 2 * 3 * LAUNCHES_PER_BLOCK


def test_chain_rejects_float32_on_the_card(cuda):
    from super_resolution_tpu_torch.ops.dense_block import dense_block_chain

    x, ws, bs = _block((1, 16, 16, 16), 8, torch.float32, cuda)[:3]
    with pytest.raises(TypeError, match="bfloat16"):
        dense_block_chain(x, [[(ws, bs)]], res_scale=0.2, slope=0.2)


# SwinIR: the window-attention kernel and the add-and-LayerNorm kernel
# against their plain versions, the model against the float32 reference,
# and RRDBNet's tail after its move into models/tail.py.

@pytest.mark.parametrize("hp,wp", [(64, 64), (72, 104)])
@pytest.mark.parametrize("shift", [0, 4])
def test_window_attention_kernel_matches_plain(cuda, hp, wp, shift):
    """SwinIR-L's widths (240, 8 heads of 30), bf16 qkv of order 1 and a
    table N(0, 1): the kernel within two bf16 ULPs of the float32 plain
    version (its output is rounded once, P once for P·v), one launch,
    the windows counted; the plain version at the other shift lies far
    outside."""
    from super_resolution_tpu_torch.metrics import recording, span_report
    from super_resolution_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device=cuda).manual_seed(hp + shift)
    qkv = torch.randn(2, hp, wp, 720, generator=gen,
                      device=cuda).to(torch.bfloat16)
    table = torch.randn(8, 225, generator=gen, device=cuda)
    before = wa.window_attention.launches
    with recording():
        got = wa.window_attention(qkv, table, 8, shift)
        counters = span_report()["counters"]
    assert wa.window_attention.launches == before + 1
    assert counters["window_attention.windows"] == 2 * hp * wp // 64 * 8
    assert counters.get("window_attention.shifted", 0) == int(shift > 0)
    ref = wa.window_attention_plain(qkv.float(), table, 8, shift)
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)
    other = wa.window_attention_plain(qkv.float(), table, 8, 4 - shift)
    assert (got.float() - other).abs().max() > 20 * atol


def test_window_attention_rejects_instead_of_falling_back(cuda):
    from super_resolution_tpu_torch.ops import window_attention as wa

    qkv = torch.zeros(1, 16, 16, 720, device=cuda)
    table = torch.zeros(8, 225, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        wa.window_attention(qkv, table, 8, 0)
    with pytest.raises(ValueError, match="table"):
        wa.window_attention(qkv.to(torch.bfloat16), table.t(), 8, 0)


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ULP at each value of ``t`` (8 significant bits), never
    below the ULP at 2**-8."""
    _, e = torch.frexp(t.float().abs().clamp(min=2.0 ** -8))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("shape", [(1, 1024, 1024, 240), (2, 72, 104, 240),
                                   (1, 64, 64, 180), (1, 64, 64, 60),
                                   (1, 37, 41, 240), (3, 37, 41, 180)])
@pytest.mark.parametrize("with_branch", [True, False])
def test_add_layernorm_kernel_matches_plain(cuda, shape, with_branch):
    """The kernel against PyTorch's bf16 add and ``F.layer_norm`` on the
    card: ``s`` bit for bit; ``h`` within one bf16 ULP of the value
    (below 2**-8, of 2**-8: the kernel sums the statistics in another
    order than PyTorch's Welford pass, a float32 difference far under
    that).  37 × 41 and 3 × 37 × 41 rows are no multiple of a block's 4
    rows: the last block's spare warps leave.  Weight
    and bias swapped, and the branch dropped, each fail that tolerance.
    One launch a call, counted in ``add_layernorm.calls`` too;
    ``add_layernorm.fused`` counts those with a branch."""
    import torch.nn.functional as F

    from super_resolution_tpu_torch.metrics import recording, span_report
    from super_resolution_tpu_torch.ops import add_layernorm as aln

    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=cuda) * 2 + 0.5
         ).to(torch.bfloat16)
    branch = torch.randn(shape, generator=gen, device=cuda
                         ).to(torch.bfloat16) if with_branch else None
    weight = (1 + 0.3 * torch.randn(c, generator=gen, device=cuda)
              ).to(torch.bfloat16)
    bias = (0.5 * torch.randn(c, generator=gen, device=cuda)
            ).to(torch.bfloat16)
    before = aln.add_layernorm.launches
    with recording():
        got = aln.add_layernorm(x, branch, weight, bias, 1e-5)
        counters = span_report()["counters"]
    assert aln.add_layernorm.launches == before + 1
    assert counters["add_layernorm.calls"] == 1
    assert counters.get("add_layernorm.fused", 0) == int(with_branch)
    s_ref = x if branch is None else x + branch
    if with_branch:
        s, h = got
        assert torch.equal(s, s_ref)
    else:
        h = got
    ref = F.layer_norm(s_ref, (c,), weight, bias, 1e-5)
    ulp = _bf16_ulp(ref)
    err = (h.float() - ref.float()).abs()
    assert (err <= ulp).all(), f"{(err / ulp).max().item()} ULP"
    swapped = aln.add_layernorm(x, branch, bias, weight, 1e-5)
    swapped = swapped[1] if with_branch else swapped
    assert ((swapped.float() - ref.float()).abs() > ulp).any()
    if with_branch:
        dropped = aln.add_layernorm(x, None, weight, bias, 1e-5)
        assert ((dropped.float() - ref.float()).abs() > ulp).any()


def test_add_layernorm_rejects_instead_of_falling_back(cuda):
    from super_resolution_tpu_torch.ops import add_layernorm as aln

    x = torch.zeros(4, 240, device=cuda)
    w, b = torch.ones(240, device=cuda), torch.zeros(240, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        aln.add_layernorm(x, x, w, b, 1e-5)
    xb = torch.zeros(4 * 240 + 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):  # misaligned
        aln.add_layernorm(xb[4:].view(4, 240), None, w.bfloat16(),
                          b.bfloat16(), 1e-5)


SWIN_CFG = dict(embed_dim=240, depths=(2, 2), num_heads=(8, 8),
                window_size=8, mlp_ratio=2.0, num_feat=64)


def _swinir_on_the_card(cuda, released, x):
    from super_resolution_tpu_torch.import_torch import import_swinir
    from super_resolution_tpu_torch.models.swinir import SwinIR

    sd, cfg = import_swinir(released)
    m = SwinIR(cfg)
    m.load_state_dict(sd)
    m = m.to(cuda).prepare(torch.bfloat16)
    with torch.inference_mode():
        return m(x.to(cuda)).cpu()


def test_swinir_on_the_card_matches_the_reference(cuda, monkeypatch):
    """SwinIR at SwinIR-L's widths, two RSTBs of a plain and a shifted
    layer, in bf16 on the card against the float32 reference on the CPU,
    on a 100 × 84 frame (padded to 104 × 88): the largest error within
    2**-5 of the largest output (bf16 rounding through 4 layers and 9
    convs, and of the bf16 residual stream at each of its 10 additions:
    2**-5.9 on the card), and the mean error four times under that of
    the same model with the cyclic shift skipped on the card.  The weights are the
    benchmark cell's kind of draw, at which the attention moves the
    output: tables ×3, the trunk's convs ×√6 (Kaiming's scale)."""
    import swinir_reference as R
    from super_resolution_tpu_torch.models import swinir as sw
    from super_resolution_tpu_torch.ops import add_layernorm as aln
    from super_resolution_tpu_torch.ops import window_attention as wa

    released = R.released_state_dict(SWIN_CFG, 7)
    tail = ("conv_before_upsample", "conv_up", "conv_hr", "conv_last")
    for k, v in released.items():
        if k.endswith("relative_position_bias_table"):
            released[k] = 3 * v
        elif v.dim() == 4 and not k.startswith(tail):
            released[k] = 6 ** 0.5 * v
    x = torch.rand(1, 100, 84, 3, generator=torch.Generator()
                   .manual_seed(8)) - 0.45
    with torch.no_grad():
        ref = R.forward(released, SWIN_CFG, x.permute(0, 3, 1, 2)
                        ).permute(0, 2, 3, 1)
    before = (wa.window_attention.launches, c3_ops.conv3x3.launches,
              aln.add_layernorm.launches)

    def no_library_layer_norm(*args, **kw):
        raise AssertionError("PyTorch's LayerNorm on the card path")

    with monkeypatch.context() as patch:
        patch.setattr(torch.nn.functional, "layer_norm",
                      no_library_layer_norm)
        got = _swinir_on_the_card(cuda, released, x)
    # 2 · Σ depths adds with the next LayerNorm, and the two at the head
    assert (wa.window_attention.launches - before[0],
            c3_ops.conv3x3.launches - before[1],
            aln.add_layernorm.launches - before[2]) == (
                4, 2 * 2 + 2 + 1 + 1 + 3, 2 * 4 + 2)
    err = (got - ref).abs()
    real = sw.window_attention
    monkeypatch.setattr(sw, "window_attention",
                        lambda qkv, table, heads, shift:
                        real(qkv, table, heads, 0))
    fault = (_swinir_on_the_card(cuda, released, x) - ref).abs()
    print(f"swinir on the card: error max {err.max().item():.3e} mean "
          f"{err.mean().item():.3e} (largest output "
          f"{ref.abs().max().item():.3e}); shift skipped: mean "
          f"{fault.mean().item():.3e}")
    assert err.max() <= 2.0 ** -5 * ref.abs().max()
    assert fault.mean() > 4 * err.mean()


def test_rrdb_forward_after_the_tail_move(cuda):
    """The flagship bf16 forward (23 blocks, auto and pallas_cf_tail) bit
    for bit against the tail as models/rrdb.py computed it before it
    moved into models/tail.py, with the chain's figures per forward: 345
    dense-block launches, 68 blocks chained, 1 input copy."""
    from super_resolution_tpu_torch.metrics import recording, span_report
    from test_torch_swinir import _tail_before_the_move

    x = torch.randn(1, 32, 40, 3, generator=torch.Generator()
                    .manual_seed(3)).to(cuda)
    for impl in ("auto", "pallas_cf_tail"):
        cfg = GeneratorConfig(conv_impl=impl, init="torch_default")
        model = rrdb.RRDBNet(cfg, torch.Generator().manual_seed(2)).to(cuda)
        model.prepare(torch.bfloat16)
        xc = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            with recording():
                got = model._forward_nchw(xc)
                torch.cuda.synchronize()
                counters = span_report()["counters"]
            fea = model.conv_first(xc)
            want = _tail_before_the_move(model, fea, model.trunk(fea))
        assert torch.equal(got, want), impl
        assert counters["launches.dense_block"] == 345
        assert counters["dense_block.chained"] == 68
        assert counters["dense_block.input_copies"] == 1
