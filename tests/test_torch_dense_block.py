"""The port's dense block (``super_resolution_tpu_torch.ops.dense_block``)
against the JAX package's Pallas kernels ``fused_dense_block_cf5`` and
``fused_dense_block_cf9``, run in interpret mode on the CPU.

On a CPU tensor the port's wrapper takes its plain PyTorch version,
which keeps the Pallas kernels' rounding points (f32 accumulation, f32
bias, every conv output rounded to x's dtype, conv5 rounded before the
f32 residual).  Inputs and weights are drawn with numpy from a seed and
handed to both sides.

Any conv count and any widths, as the JAX kernels take them: the five
geometries of ``GEOMETRIES`` (``tests/test_pallas.py``'s (n_convs, nf,
gc) = (4, 8, 4), (5, 16, 4), (3, 8, 8), plus widths that are not
multiples of 8 and widths above 64) against a lax block, one of them
against the Pallas kernel, and the bf16 kernel's padded feature buffer
emulated on the CPU.

Tolerances: float32 at atol = rtol = 1e-5 (the two sides sum the 3x3
taps in another order).  bfloat16 at atol = rtol = 2**-6, about two
bf16 ULPs: an f32 sum taken in another order can flip the bf16 rounding
of one conv output by one ULP, and later convs of the block carry it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
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
    _padded_params,
    dense_block,
    dense_block_plain,
    fwd_launches,
    layout,
    pack_weight,
    unpack_weight,
)

NF, GC = 16, 8
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -6)}
# (n_convs, nf, gc): tests/test_pallas.py's general geometries, widths
# that are not multiples of 8, widths above 64
GEOMETRIES = [(4, 8, 4), (5, 16, 4), (3, 8, 8), (5, 12, 6), (5, 96, 72)]
GEOMETRY_IDS = [f"n{n}_c{c}_g{g}" for n, c, g in GEOMETRIES]


def _block_inputs(seed, shape, nf=NF, gc=GC, n=5):
    """x (any shape) and the HWIO weights / f32 biases of an n-conv block
    of nf channels and growth gc, float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    ws, bs = [], []
    cin = nf
    for k in range(n):
        cout = nf if k == n - 1 else gc
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
    if bad == "channels":           # conv3's cin does not match the buffer
        wt[2] = wt[2][..., :-1].contiguous()
    elif bad == "dtype":
        xt = xt.to(torch.float16)
    elif bad == "packing":
        wt[0] = torch.from_numpy(ws[0]).permute(3, 2, 0, 1)
    else:
        xt = xt.permute(0, 1, 3, 2)
    with pytest.raises((ValueError, TypeError)):
        dense_block(xt, wt, bt, res_scale=0.2, slope=0.2)


def _lax_block(x, ws, bs, slope=0.2):
    """The textbook block on NCHW x in float32 (lax, HIGHEST)."""
    feats = jnp.asarray(x)
    for k, (w, b) in enumerate(zip(ws, bs)):
        y = jax.lax.conv_general_dilated(
            feats, jnp.asarray(w), (1, 1), "SAME",
            dimension_numbers=("NCHW", "HWIO", "NCHW"),
            precision=jax.lax.Precision.HIGHEST) + jnp.asarray(b)[:, None,
                                                                 None]
        if k < len(ws) - 1:
            feats = jnp.concatenate([feats, jnp.where(y >= 0, y, slope * y)],
                                    1)
    return np.asarray(jnp.asarray(x) + 0.2 * y)


@pytest.mark.parametrize("n,nf,gc", GEOMETRIES, ids=GEOMETRY_IDS)
def test_any_conv_count_and_width_matches_lax(n, nf, gc):
    x, ws, bs = _block_inputs(21, (2, nf, 10, 13), nf=nf, gc=gc, n=n)
    got = _port(x, ws, bs, "float32", 0.2)
    np.testing.assert_allclose(got, _lax_block(x, ws, bs), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unaligned_widths_match_pallas(dtype):
    """C 12, growth 6: the Pallas kernel takes any width; so does the
    port."""
    x, ws, bs = _block_inputs(22, (1, 12, 16, 24), nf=12, gc=6)
    ref = _pallas(fused_dense_block_cf5, x, ws, bs, dtype, 0.2, rows=8)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(_port(x, ws, bs, dtype, 0.2), ref, atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("n,nf,gc", [(5, 12, 6), (4, 8, 4), (3, 20, 16)],
                         ids=["n5_c12_g6", "n4_c8_g4", "n3_c20_g16"])
def test_padded_buffer_is_the_block(n, nf, gc):
    """The bf16 kernel's feature buffer, emulated in float32 on the CPU:
    C and G padded to 8 inside the buffer, the weights re-laid with zero
    rows and columns, one conv per launch on the buffer's channel prefix
    into its slice.  y equals the block, and the padded channels stay 0."""
    x, ws, bs = _block_inputs(23, (2, nf, 9, 11), nf=nf, gc=gc, n=n)
    xt = torch.from_numpy(x)
    wt = [pack_weight(torch.from_numpy(w).permute(3, 2, 0, 1)) for w in ws]
    bt = [torch.from_numpy(b) for b in bs]
    lay = layout(nf, gc, n, torch.bfloat16)
    assert lay.padded == (nf % 8 != 0 or gc % 8 != 0)
    wp, bp = _padded_params(wt, bt, lay)
    buf = torch.zeros(2, lay.c_total, 9, 11)
    buf[:, :nf] = xt
    for k in range(n):
        cin = lay.offset(k + 1)
        assert wp[k].shape[2] == cin
        o = F.conv2d(buf[:, :cin], unpack_weight(wp[k]), bp[k], padding=1)
        if k < n - 1:
            buf[:, cin:cin + wp[k].shape[1]] = F.leaky_relu(o, 0.2)
    y = xt + 0.2 * o
    ref = dense_block_plain(xt, wt, bt, res_scale=0.2, slope=0.2)
    torch.testing.assert_close(y, ref, atol=1e-6, rtol=1e-6)
    real = torch.zeros(lay.c_total, dtype=torch.bool)
    real[:nf] = True
    for j in range(1, n):
        real[lay.offset(j):lay.offset(j) + gc] = True
    assert torch.equal(buf[:, ~real], torch.zeros_like(buf[:, ~real]))
    assert fwd_launches(n) == n
