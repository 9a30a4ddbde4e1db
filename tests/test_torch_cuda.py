"""Tests of the port that need the card: the dense-block CUDA kernels,
forward and backward, against their plain versions, their launch counts
and input checks, and the generator, a training step and the CLI on
CUDA.  Marked ``cuda``; each skips where torch sees
no CUDA device.  On a machine with a card (no JAX needed there):

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
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.config import GeneratorConfig
from super_resolution_tpu_torch.models import rrdb
from super_resolution_tpu_torch.ops.dense_block import (
    BWD_LAUNCHES_PER_BLOCK,
    LAUNCHES_PER_BLOCK,
    dense_block,
    dense_block_bwd,
    dense_block_plain,
    dense_block_train,
    pack_weight,
    plain_backward,
    plain_forward,
)

pytestmark = pytest.mark.cuda

# the module: the package's ``ops`` exports a function of the same name
db_ops = importlib.import_module("super_resolution_tpu_torch.ops.dense_block")

TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2.0 ** -6, 2.0 ** -6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _block(shape, growth, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    b, c, h, w = shape
    x = torch.randn(shape, generator=gen).to(device, dtype)
    ws, bs, cin = [], [], c
    for k in range(5):
        cout = c if k == 4 else growth
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
    assert dense_block_bwd.launches == before + BWD_LAUNCHES_PER_BLOCK
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


def test_train_function_launches_both_kernels(cuda):
    """autograd through dense_block_train on the card: five forward and
    fifteen backward launches, dW in the weights' dtype, a non-contiguous
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
                                 n_blocks * BWD_LAUNCHES_PER_BLOCK)
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
