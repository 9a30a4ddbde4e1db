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
- Any conv count and width: v3–v6 and v8 with 4 convs, 12 channels and
  growth 6 against their Pallas kernels, at the tolerances above.
- v8, bfloat16: 2^-6 of the largest |y| (measured 0 at this case; XLA
  may contract the bf16 residual into an FMA, which the port rounds in
  two steps, so a y near a bf16 rounding boundary can differ by an
  ULP).
- v8's CUDA launches, by their plain versions: the weight prep
  (``prep_weights_plain``) equal to the JAX kernel's quantization in
  every integer and scale; the fused amax (``fused_amax_plain``) equal
  to the window amax of every conv; the banding (``band_plain``) equal
  to the bands of x.  Exact: each is a max, a copy or the same f32
  steps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from super_resolution_tpu.ops.pallas import experiments_dense_block as J
from super_resolution_tpu_torch.ops import experiments_dense_block as P


def _inputs(seed, shape, gc, scale=0.05, n=5):
    """x (B, C, H, W), HWIO weights and f32 biases of an n-conv block,
    float32 numpy."""
    rng = np.random.default_rng(seed)
    nf = shape[1]
    x = rng.standard_normal(shape).astype(np.float32)
    ws, bs, cin = [], [], nf
    for k in range(n):
        cout = nf if k == n - 1 else gc
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
    assert P.INT8_LAUNCHES_PER_CALL == 7          # n + 2 at n = 5


@pytest.mark.parametrize("name", ["cf", "cf2", "cf3", "cf6", "cf8"])
def test_any_conv_count_and_width_matches_pallas(name):
    """4 convs of growth 6 on 12 channels (neither a multiple of 8)."""
    x, ws, bs = _inputs(8, (1, 12, 16, 20), 6, scale=0.1, n=4)
    fn = f"fused_dense_block_{name}"
    ref = _jax(getattr(J, fn), x, ws, bs, rows=8)
    got = _port(getattr(P, fn), x, ws, bs, rows=8)
    assert got.shape == ref.shape == x.shape
    if name == "cf8":
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    assert P.int8_launches(4) == 6


def _jax_quantize(ws):
    """The JAX kernel's weight quantization (experiments_dense_block.py,
    fused_dense_block_cf8), jitted as it runs there: XLA folds its
    ``/ 127.0`` into a multiplication, as the port does."""
    import jax

    @jax.jit
    def quant(wk):
        wp = J.pack_weights_v6(wk).astype(jnp.float32)     # (3F, 3C)
        s = jnp.maximum(jnp.max(jnp.abs(wp), axis=1), 1e-12) / 127.0
        return (jnp.clip(jnp.round(wp / s[:, None]), -127, 127)
                .astype(jnp.int8), s)

    return [tuple(np.asarray(a) for a in quant(jnp.asarray(w))) for w in ws]


@pytest.mark.parametrize("n,c,g", [(5, 16, 8), (4, 12, 6), (1, 12, 0)],
                         ids=["n5_c16_g8", "n4_c12_g6", "n1_c12"])
def test_int8_prep_weights_plain_matches_jax(n, c, g):
    """The weight-prep launch's plain version against the JAX kernel's
    quantization: at every real (dy, dx, f, c) the same integer, every
    row the same scale; padded output rows zero with the scale
    1e-12/127, padded input columns zero, biases padded with zeros.  One
    output channel of conv 2 is all zero (the JAX scale 1e-12/127)."""
    from super_resolution_tpu_torch.ops.dense_block import layout

    _, ws, bs = _inputs(9, (1, c, 8, 8), g, scale=0.1, n=n)
    if n > 1:
        ws[1][..., 0] = 0.0
    ref = _jax_quantize(ws)
    lay = layout(c, g, n, torch.bfloat16)
    got = P.prep_weights_plain([torch.from_numpy(w) for w in ws],
                               [torch.from_numpy(b) for b in bs], lay)
    zero_scale = np.float32(1e-12) * np.float32(P.RECIP127)
    for k, ((wq_ref, s_ref), (wq, sw, bias)) in enumerate(zip(ref, got)):
        cin, cout = ws[k].shape[2], ws[k].shape[3]
        cout_p = c if k == n - 1 else lay.gp
        cpad = -(-lay.offset(k + 1) // 32) * 32
        assert wq.dtype == torch.int8
        assert tuple(wq.shape) == (9, cout_p, cpad)
        pos = lay.positions(cin)
        w5 = wq.numpy().reshape(3, 3, cout_p, cpad)
        # JAX: row dx·F + f, column dy·C + c
        real = wq_ref.reshape(3, cout, 3, cin).transpose(2, 0, 1, 3)
        np.testing.assert_array_equal(w5[:, :, :cout][..., pos], real)
        others = np.setdiff1d(np.arange(cpad), pos)
        assert not w5[..., others].any() and not w5[:, :, cout:].any()
        sw = sw.numpy().reshape(3, cout_p)
        np.testing.assert_array_equal(sw[:, :cout], s_ref.reshape(3, cout))
        assert (sw[:, cout:] == zero_scale).all()
        np.testing.assert_array_equal(bias.numpy()[:cout], bs[k])
        assert not bias.numpy()[cout:].any()
    if n > 1:
        assert (got[1][1].numpy().reshape(3, -1)[:, 0] == zero_scale).all()
        assert not got[1][0].numpy().reshape(9, lay.gp, -1)[:, 0].any()


@pytest.mark.parametrize("n,c,g,dtype", [
    (5, 16, 8, "float32"), (4, 12, 6, "float32"), (4, 12, 6, "bfloat16")],
    ids=["n5_c16_g8", "n4_c12_g6", "n4_c12_g6_bf16"])
def test_int8_fused_amax_equals_window_amax(n, c, g, dtype):
    """Each conv's amax from the row maxima the epilogues gather (slices
    0..k over band rows [k, band_rows - k)) equals the amax of its input
    window as the JAX kernel takes it, for every k, in two bands; and
    the banding's plain version gives the bands of x and slice 0's row
    maxima."""
    from super_resolution_tpu_torch.ops.dense_block import layout

    rows = 8
    x, ws, bs = _inputs(10, (2, c, 2 * rows, 20), g, scale=0.1, n=n)
    x[:, :, 1:3, 4:9] *= 5.0                # one band's scale differs
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    rec = {}
    P.fused_dense_block_cf8_plain(xt, [torch.from_numpy(w).to(tdt)
                                       for w in ws],
                                  [torch.from_numpy(b) for b in bs],
                                  rows=rows, record=rec)
    row_max = rec["row_max"]
    assert tuple(row_max.shape) == (n, 2 * 2, rows + 2 * n)
    for k in range(n):
        fused = P.fused_amax_plain(row_max, k)
        assert torch.equal(fused, rec["window_amax"][k]), k
    assert len(set(rec["window_amax"][0].tolist())) > 1
    lay = layout(c, g, n, torch.bfloat16)
    buf, amax0 = P.band_plain(xt, rows, lay)
    assert torch.equal(amax0, row_max[0])
    bands = P._bands(xt, rows, n).permute(0, 1, 3, 4, 2)
    assert torch.equal(buf[..., :c], bands.reshape(buf.shape[:3] + (c,)))
    assert not buf[..., c:].float().any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_rounding_equals_clip_rint(dtype):
    """The conv kernel's quantization, emulated in float32: rint as the
    low byte of fl(fl(v·inv) + 1.5·2^23), with no clip, equals
    clip(rint(v·inv), -127, 127) for every value of a window (|v| <=
    amax), at amax far below 1e-6, at ±amax itself and at half-integer
    products (round half to even)."""
    rng = np.random.default_rng(11)
    amax = np.concatenate([rng.uniform(1e-9, 64.0, 400),
                           [1e-9, 5e-7, 1e-6, 1.0, 3.0, 127.0]])
    amax = torch.from_numpy(amax.astype(np.float32)).to(
        getattr(torch, dtype)).float().numpy()
    recip = np.float32(P.RECIP127)
    for a in amax:
        s_x = np.float32(max(a, np.float32(1e-6))) * recip
        inv = np.float32(1.0) / s_x
        v = rng.uniform(-a, a, 512).astype(np.float32)
        v = np.concatenate([v, [a, -a, 0.0],
                            (np.arange(-4, 5) + 0.5) * s_x]).astype(np.float32)
        v = torch.from_numpy(v).to(getattr(torch, dtype)).float().numpy()
        v = v[np.abs(v) <= a]
        prod = (v * inv).astype(np.float32)
        want = np.clip(np.rint(prod), -127, 127).astype(np.int8)
        bits = (prod + np.float32(12582912.0)).astype(np.float32) \
            .view(np.uint32)
        got = (bits & 0xFF).astype(np.uint8).view(np.int8)
        np.testing.assert_array_equal(got, want)
