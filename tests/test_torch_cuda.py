"""Tests of the port that need the card: the dense-block CUDA kernel
against its plain version, its launch count and input checks, and the
generator and CLI on CUDA.  Marked ``cuda``; each skips where torch sees
no CUDA device.  On a machine with a card (no JAX needed there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: float32 atol 2e-5 + rtol 1e-5 (the same
arithmetic summed in another order), bfloat16 atol = rtol = 2**-6
(about two bf16 ULPs: a flipped rounding of one conv output carries
through the later convs of the block).
"""

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
    LAUNCHES_PER_BLOCK,
    dense_block,
    dense_block_plain,
    pack_weight,
)

pytestmark = pytest.mark.cuda

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
