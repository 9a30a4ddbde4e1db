"""The port's dense block (``super_resolution_tpu_torch.ops.dense_block``)
against the JAX package's Pallas kernels ``fused_dense_block_cf5`` and
``fused_dense_block_cf9``, run in interpret mode on the CPU.

On a CPU tensor the port's wrapper takes its plain PyTorch version,
which keeps the Pallas kernels' rounding points (f32 accumulation, f32
bias, every conv output rounded to x's dtype, conv5 rounded before the
f32 residual).  Inputs and weights are drawn with numpy from a seed and
handed to both sides.

Tolerances: float32 at atol = rtol = 1e-5 (the two sides sum the 3x3
taps in another order).  bfloat16 at atol = rtol = 2**-6, about two
bf16 ULPs: an f32 sum taken in another order can flip the bf16 rounding
of one conv output by one ULP, and later convs of the block carry it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from super_resolution_tpu.ops.pallas.dense_block_cf import (
    fused_dense_block_cf5,
)
from super_resolution_tpu.ops.pallas.dense_block_cf_ext import (
    fused_dense_block_cf9,
)
from super_resolution_tpu_torch.ops.dense_block import (
    LAUNCHES_PER_BLOCK,
    dense_block,
    pack_weight,
    unpack_weight,
)

NF, GC = 16, 8
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -6)}


def _block_inputs(seed, shape, nf=NF, gc=GC):
    """x (B, C, H, W) and HWIO weights / f32 biases, float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    ws, bs = [], []
    cin = nf
    for k in range(5):
        cout = nf if k == 4 else gc
        ws.append((rng.standard_normal((3, 3, cin, cout))
                   * np.sqrt(2.0 / (9 * cin))).astype(np.float32))
        bs.append((rng.standard_normal(cout) * 0.1).astype(np.float32))
        cin += gc
    return x, ws, bs


def _port(x, ws, bs, dtype, slope):
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    wt = [pack_weight(torch.from_numpy(w).permute(3, 2, 0, 1)).to(tdt)
          for w in ws]
    bt = [torch.from_numpy(b) for b in bs]
    return dense_block(xt, wt, bt, res_scale=0.2, slope=slope).float() \
        .numpy()


def _pallas(kernel, x, ws, bs, dtype, slope, rows):
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        y = kernel(jnp.asarray(x).astype(jdt),
                   [jnp.asarray(w).astype(jdt) for w in ws],
                   [jnp.asarray(b) for b in bs], rows=rows, res_scale=0.2,
                   slope=slope)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,shape", [
    (fused_dense_block_cf9, (2, NF, 16, 128)),   # the 128-wide tile path
    (fused_dense_block_cf5, (2, NF, 16, 128)),
    (fused_dense_block_cf5, (2, NF, 16, 40)),    # unaligned width
], ids=["cf9_w128", "cf5_w128", "cf5_w40"])
def test_dense_block_matches_pallas(kernel, shape, dtype):
    x, ws, bs = _block_inputs(3, shape)
    ref = _pallas(kernel, x, ws, bs, dtype, 0.2, rows=8)
    got = _port(x, ws, bs, dtype, 0.2)
    assert got.shape == ref.shape == shape
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


def test_dense_block_growth_equals_filters_slope_001():
    """The eriklindernoren variant: growth == filters, LeakyReLU 0.01."""
    x, ws, bs = _block_inputs(5, (1, NF, 8, 128), nf=NF, gc=NF)
    ref = _pallas(fused_dense_block_cf9, x, ws, bs, "float32", 0.01, rows=8)
    got = _port(x, ws, bs, "float32", 0.01)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_plain_version_matches_reference_block():
    """Odd geometry (H % 8 != 0, where the JAX package falls back to
    lax): the plain version against the textbook block in float64."""
    x, ws, bs = _block_inputs(7, (1, NF, 13, 19))
    got = _port(x, ws, bs, "float32", 0.2)
    feats = [torch.from_numpy(x).double()]
    for k in range(5):
        o = torch.nn.functional.conv2d(
            torch.cat(feats, 1),
            torch.from_numpy(ws[k]).permute(3, 2, 0, 1).double(),
            torch.from_numpy(bs[k]).double(), padding=1)
        if k < 4:
            feats.append(torch.nn.functional.leaky_relu(o, 0.2))
    ref = (feats[0] + 0.2 * o).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_pack_weight_layout_and_inverse():
    w = torch.arange(4 * 3 * 3 * 3, dtype=torch.float32).reshape(4, 3, 3, 3)
    p = pack_weight(w)
    assert p.shape == (9, 4, 3)
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(p[dy * 3 + dx], w[:, :, dy, dx])
    assert torch.equal(unpack_weight(p), w)


def test_cpu_path_counts_no_launches():
    x, ws, bs = _block_inputs(9, (1, NF, 8, 8))
    before = dense_block.launches
    _port(x, ws, bs, "float32", 0.2)
    assert dense_block.launches == before
    assert LAUNCHES_PER_BLOCK == 5


@pytest.mark.parametrize("bad", ["channels", "dtype", "packing", "layout"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, ws, bs = _block_inputs(11, (1, NF, 8, 8))
    xt = torch.from_numpy(x)
    wt = [pack_weight(torch.from_numpy(w).permute(3, 2, 0, 1)) for w in ws]
    bt = [torch.from_numpy(b) for b in bs]
    if bad == "channels":           # growth 4 is not a multiple of 8
        x, ws, bs = _block_inputs(11, (1, NF, 8, 8), gc=4)
        wt = [pack_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
              for w in ws]
        bt = [torch.from_numpy(b) for b in bs]
    elif bad == "dtype":
        xt = xt.to(torch.float16)
    elif bad == "packing":
        wt[0] = torch.from_numpy(ws[0]).permute(3, 2, 0, 1)
    else:
        xt = xt.permute(0, 1, 3, 2)
    with pytest.raises((ValueError, TypeError)):
        dense_block(xt, wt, bt, res_scale=0.2, slope=0.2)
