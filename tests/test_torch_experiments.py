"""The port's experiment dense-block kernels
(``super_resolution_tpu_torch.ops.experiments_dense_block``) against the
JAX package's Pallas kernels v3, v3b, v4, v6 and v8, run in interpret
mode on the CPU, at ``tests/test_pallas.py``'s shapes and band heights.

On a CPU tensor each port wrapper runs its plain version: v3–v6 the
dense block's (``ops.dense_block.dense_block_plain``), v8
``fused_dense_block_cf8_plain``.  Inputs and weights are drawn with
numpy from a seed and handed to both sides.

Tolerances:
- v3–v6, float32: atol 2e-5, rtol 1e-4 (``tests/test_pallas.py``'s for
  these kernels; the two sides sum the taps in another order).
- v8, float32: 1e-6 of the largest |y|, and equal is expected (measured
  0 in every case): the quantized operands and the int32 sums are the
  same integers on both sides, and the port takes the one FMA XLA makes
  of the middle tap's shift-add.  A quantized value rounded the other
  way would move y by about 1e-3 and fail.
- v8, bfloat16: 2^-6 of the largest |y| (measured 0 at this case; XLA
  may contract the bf16 residual into an FMA, which the port rounds in
  two steps, so a y near a bf16 rounding boundary can differ by an
  ULP).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from super_resolution_tpu.ops.pallas import experiments_dense_block as J
from super_resolution_tpu_torch.ops import experiments_dense_block as P


def _inputs(seed, shape, gc, scale=0.05):
    """x (B, C, H, W), HWIO weights and f32 biases, float32 numpy."""
    rng = np.random.default_rng(seed)
    nf = shape[1]
    x = rng.standard_normal(shape).astype(np.float32)
    ws, bs, cin = [], [], nf
    for k in range(5):
        cout = nf if k == 4 else gc
        ws.append((rng.standard_normal((3, 3, cin, cout)) * scale)
                  .astype(np.float32))
        bs.append((rng.standard_normal(cout) * 0.1).astype(np.float32))
        cin += gc
    return x, ws, bs


def _jax(fn, x, ws, bs, dtype="float32", **kw):
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        out = fn(jnp.asarray(x).astype(jdt),
                 [jnp.asarray(w).astype(jdt) for w in ws],
                 [jnp.asarray(b) for b in bs], **kw)
    if isinstance(out, tuple):
        return (np.asarray(out[0].astype(jnp.float32)),
                [np.asarray(a.astype(jnp.float32)) for a in out[1]])
    return np.asarray(out.astype(jnp.float32))


def _port(fn, x, ws, bs, dtype="float32", **kw):
    tdt = getattr(torch, dtype)
    out = fn(torch.from_numpy(x).to(tdt),
             [torch.from_numpy(w).to(tdt) for w in ws],
             [torch.from_numpy(b) for b in bs], **kw)
    if isinstance(out, tuple):
        return out[0].float().numpy(), [a.float().numpy() for a in out[1]]
    return out.float().numpy()


# test_pallas.py's NHWC shapes (B, H, W, C), here NCHW, growth 16
ROUTED = [
    ("cf", (1, 32, 16, 40), 8), ("cf", (2, 32, 32, 64), 16),
    ("cf2", (1, 32, 16, 40), 8), ("cf2", (2, 32, 32, 64), 16),
    ("cf2", (1, 32, 24, 100), 12),
    ("cf3", (1, 32, 16, 40), 8), ("cf3", (2, 32, 32, 64), 16),
    ("cf3", (1, 32, 64, 48), 32),
    ("cf6", (1, 32, 16, 40), 8), ("cf6", (2, 32, 32, 64), 16),
]


@pytest.mark.parametrize("name,shape,rows", ROUTED,
                         ids=[f"{n}_{s[2]}x{s[3]}_r{r}" for n, s, r in ROUTED])
def test_routed_variant_matches_pallas(name, shape, rows):
    x, ws, bs = _inputs(0, shape, 16)
    fn = f"fused_dense_block_{name}"
    ref = _jax(getattr(J, fn), x, ws, bs, rows=rows)
    got = _port(getattr(P, fn), x, ws, bs, rows=rows)
    assert got.shape == ref.shape == shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def test_cf3_save_acts_matches_pallas():
    x, ws, bs = _inputs(1, (2, 32, 32, 48), 16)
    y_ref, acts_ref = _jax(J.fused_dense_block_cf3, x, ws, bs, rows=16,
                           save_acts=True)
    y, acts = _port(P.fused_dense_block_cf3, x, ws, bs, rows=16,
                    save_acts=True)
    np.testing.assert_allclose(y, y_ref, atol=2e-5, rtol=1e-4)
    assert len(acts) == len(acts_ref) == 4
    for a, r in zip(acts, acts_ref):
        assert a.shape == r.shape == (2, 16, 32, 48)
        np.testing.assert_allclose(a, r, atol=2e-5, rtol=1e-4)


def test_pack_weights_v6_matches_jax():
    w = np.random.default_rng(2).standard_normal((3, 3, 24, 16)) \
        .astype(np.float32)
    ref = np.asarray(J.pack_weights_v6(jnp.asarray(w)))
    got = P.pack_weights_v6(torch.from_numpy(w)).numpy()
    assert got.shape == ref.shape == (48, 72)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,rows", [
    ((1, 16, 32, 16), 8),       # tests/test_pallas.py's int8 case
    ((1, 16, 16, 20), 8),       # two bands, W not a multiple of 8
], ids=["pallas_case", "two_bands_w20"])
def test_int8_matches_pallas_fp32(shape, rows):
    x, ws, bs = _inputs(3, shape, 8, scale=0.1)
    ref = _jax(J.fused_dense_block_cf8, x, ws, bs, rows=rows)
    got = _port(P.fused_dense_block_cf8, x, ws, bs, rows=rows)
    assert got.shape == ref.shape == shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_int8_matches_pallas_bf16():
    x, ws, bs = _inputs(4, (1, 16, 16, 24), 8, scale=0.1)
    ref = _jax(J.fused_dense_block_cf8, x, ws, bs, "bfloat16", rows=8)
    got = _port(P.fused_dense_block_cf8, x, ws, bs, "bfloat16", rows=8)
    assert np.abs(got - ref).max() <= 2.0 ** -6 * np.abs(ref).max()


def test_int8_bands_depend_on_rows_as_in_jax():
    """Band-local scales: rows 8 and rows 16 give other values, and the
    port's two results differ from each other as the JAX kernel's do."""
    x, ws, bs = _inputs(5, (1, 16, 32, 16), 8, scale=0.1)
    # a bright spot in the first band: its scale differs from the rest
    x[:, :, 2:4, 3:6] *= 6.0
    ref = {r: _jax(J.fused_dense_block_cf8, x, ws, bs, rows=r)
           for r in (8, 16)}
    got = {r: _port(P.fused_dense_block_cf8, x, ws, bs, rows=r)
           for r in (8, 16)}
    ref_delta, got_delta = ref[8] - ref[16], got[8] - got[16]
    assert np.abs(ref_delta).max() > 1e-3
    np.testing.assert_array_equal(got_delta != 0, ref_delta != 0)
    assert np.abs(got_delta - ref_delta).max() <= 1e-6 * np.abs(ref[8]).max()


@pytest.mark.parametrize("bad", ["rows_not_dividing", "rows_below_5"])
def test_band_height_contract(bad):
    x, ws, bs = _inputs(6, (1, 16, 16, 16), 8)
    rows = 6 if bad == "rows_not_dividing" else 4
    for fn in (P.fused_dense_block_cf, P.fused_dense_block_cf2,
               P.fused_dense_block_cf3, P.fused_dense_block_cf6,
               P.fused_dense_block_cf8):
        with pytest.raises(ValueError, match="band height"):
            _port(fn, x, ws, bs, rows=rows)


def test_cpu_wrappers_count_no_launches():
    x, ws, bs = _inputs(7, (1, 16, 8, 8), 8)
    fns = (P.fused_dense_block_cf, P.fused_dense_block_cf2,
           P.fused_dense_block_cf3, P.fused_dense_block_cf6,
           P.fused_dense_block_cf8)
    before = [f.launches for f in fns]
    for f in fns:
        _port(f, x, ws, bs, rows=8)
    assert [f.launches for f in fns] == before
    assert P.INT8_LAUNCHES_PER_CALL == 10
