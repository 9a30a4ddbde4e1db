"""The port's dense-block backward (``ops.dense_block``:
``dense_block_bwd_plain`` and ``torch.autograd.grad`` through
``dense_block_train``) against the JAX package's Pallas backward
``fused_dense_block_cf5_bwd`` / ``jax.grad`` of ``dense_block_cf_train``
in interpret mode on the CPU, and against ``jax.grad`` of a plain lax
block.

On a CPU tensor the port's ``autograd.Function`` takes the plain
versions, which keep the Pallas kernel's rounding points and its
LeakyReLU gradient (the slope branch where a saved activation is exactly
0).  Inputs are drawn with numpy from a seed and handed to both sides.

Tolerances, float32: the JAX tests' own (``tests/test_pallas.py``), dx
atol 2e-4 rtol 1e-4, dW and db atol 5e-4 rtol 1e-4 — the two sides sum
taps and pixels in another order.  bfloat16: see the test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from super_resolution_tpu.ops.pallas.dense_block_cf import (
    fused_dense_block_cf5,
)
from super_resolution_tpu.ops.pallas.dense_block_cf_vjp import (
    dense_block_cf_train,
    fused_dense_block_cf5_bwd,
)
from super_resolution_tpu_torch.ops.dense_block import (
    dense_block,
    dense_block_bwd,
    dense_block_bwd_plain,
    dense_block_plain,
    dense_block_train,
    feature_buffer,
    pack_weight,
    split_features,
    unpack_weight,
    wgrad_parts,
)

DX_TOL = dict(atol=2e-4, rtol=1e-4)
DW_TOL = dict(atol=5e-4, rtol=1e-4)


def _inputs(seed, shape, gc, scale=0.1):
    """x, target (B, C, H, W), HWIO weights, biases: float32 numpy."""
    rng = np.random.default_rng(seed)
    nf = shape[1]
    x = rng.standard_normal(shape).astype(np.float32)
    tgt = rng.standard_normal(shape).astype(np.float32)
    ws, bs, cin = [], [], nf
    for k in range(5):
        cout = nf if k == 4 else gc
        ws.append((rng.standard_normal((3, 3, cin, cout)) * scale)
                  .astype(np.float32))
        bs.append((rng.standard_normal(cout) * 0.1).astype(np.float32))
        cin += gc
    return x, tgt, ws, bs


def _packed(ws, dtype=torch.float32):
    return [pack_weight(torch.from_numpy(w).permute(3, 2, 0, 1)).to(dtype)
            for w in ws]


def _hwio(dw_packed):
    """Packed (9, cout, cin) gradient -> HWIO numpy, the JAX layout."""
    return unpack_weight(dw_packed.float()).permute(2, 3, 1, 0).numpy()


def _port_grads(x, tgt, ws, bs, slope, noncontig=False):
    """Gradients of sum((block(x) - tgt)^2) through dense_block_train."""
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [w.requires_grad_(True) for w in _packed(ws)]
    bt = [torch.from_numpy(b).requires_grad_(True) for b in bs]
    y = dense_block_train(xt, wt, bt, res_scale=0.2, slope=slope)
    if noncontig:
        # the cotangent reaches the Function as a permuted view
        loss = ((y.permute(0, 1, 3, 2) - torch.from_numpy(tgt)
                 .permute(0, 1, 3, 2)) ** 2).sum()
    else:
        loss = ((y - torch.from_numpy(tgt)) ** 2).sum()
    g = torch.autograd.grad(loss, [xt, *wt, *bt])
    return (g[0].numpy(), [_hwio(d) for d in g[1:6]],
            [d.numpy() for d in g[6:]])


def _lax_block(x, ws, bs, slope):
    feats = x
    for k, (w, b) in enumerate(zip(ws, bs)):
        y = jax.lax.conv_general_dilated(
            feats, w, (1, 1), "SAME",
            dimension_numbers=("NCHW", "HWIO", "NCHW"),
            precision=jax.lax.Precision.HIGHEST) + b[None, :, None, None]
        if k < 4:
            feats = jnp.concatenate(
                [feats, jnp.where(y >= 0, y, slope * y)], 1)
    return x + 0.2 * y


def _assert_grads(got, want):
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **DX_TOL)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, np.asarray(b), **DW_TOL)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a, np.asarray(b), **DW_TOL)


@pytest.mark.parametrize("shape,gc,rows,slope", [
    ((2, 16, 24, 16), 8, 8, 0.2),       # unaligned width
    ((1, 8, 16, 128), 8, 8, 0.2),       # 128-wide: the Mosaic backward
    ((1, 16, 16, 24), 16, 8, 0.2),      # growth == filters
    ((1, 16, 16, 24), 8, 8, 0.01),      # the slope-0.01 family
], ids=["w16", "w128", "growth_eq_filters", "slope001"])
def test_train_grads_match_pallas_and_lax(shape, gc, rows, slope):
    x, tgt, ws, bs = _inputs(1, shape, gc)
    got = _port_grads(x, tgt, ws, bs, slope)
    jx, jt = jnp.asarray(x), jnp.asarray(tgt)
    jw, jb = [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs]

    def loss_ker(x, ws, bs):
        return jnp.sum((dense_block_cf_train(x, ws, bs, rows, 0.2, slope)
                        - jt) ** 2)

    def loss_ref(x, ws, bs):
        return jnp.sum((_lax_block(x, ws, bs, slope) - jt) ** 2)

    with pltpu.force_tpu_interpret_mode():
        gk = jax.grad(loss_ker, argnums=(0, 1, 2))(jx, jw, jb)
    _assert_grads(got, gk)
    _assert_grads(got, jax.grad(loss_ref, argnums=(0, 1, 2))(jx, jw, jb))


def test_noncontiguous_cotangent():
    x, tgt, ws, bs = _inputs(2, (1, 16, 16, 16), 8)
    a = _port_grads(x, tgt, ws, bs, 0.2)
    b = _port_grads(x, tgt, ws, bs, 0.2, noncontig=True)
    np.testing.assert_array_equal(a[0], b[0])
    for u, v in zip(a[1] + a[2], b[1] + b[2]):
        np.testing.assert_array_equal(u, v)
    feats = torch.zeros(1, 16, 16, 16 + 32)
    g = torch.zeros(1, 16, 16, 16).permute(0, 1, 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        dense_block_bwd(feats, _packed(ws), g, res_scale=0.2, slope=0.2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_pallas_bwd(dtype):
    """The kernel-level functions on the same saved activations.  bf16:
    both sides round every conv's cotangent to bf16 before the products
    and accumulate in f32, so they differ by summation order and by the
    bf16 rounding flips that order causes: dx within 2 bf16 ULPs
    (2**-7 relative), dW and db within 2**-6 of each tensor's largest
    value (sums over 384 pixels of bf16 products)."""
    shape, gc, rows = (1, 16, 24, 16), 8, 8
    x, g, ws, bs = _inputs(3, shape, gc)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt, gt = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    wt = _packed(ws, tdt)
    _, acts = dense_block_plain(xt, wt, [torch.from_numpy(b) for b in bs],
                                res_scale=0.2, slope=0.2, save_acts=True)
    dx, dws, dbs = dense_block_bwd_plain(xt, acts, wt, gt, res_scale=0.2,
                                         slope=0.2)
    assert dx.dtype == tdt and all(d.dtype == torch.float32
                                   for d in dws + dbs)
    with pltpu.force_tpu_interpret_mode():
        jdx, jdws, jdbs = fused_dense_block_cf5_bwd(
            jnp.asarray(xt.float().numpy()).astype(jdt),
            [jnp.asarray(a.float().numpy()).astype(jdt) for a in acts],
            [jnp.asarray(w).astype(jdt) for w in ws],
            jnp.asarray(gt.float().numpy()).astype(jdt), rows=rows,
            res_scale=0.2, slope=0.2)
    jdx = np.asarray(jdx.astype(jnp.float32))
    if dtype == "float32":
        _assert_grads((dx.numpy(), [_hwio(d) for d in dws],
                       [d.numpy() for d in dbs]), (jdx, jdws, jdbs))
        return
    np.testing.assert_allclose(dx.float().numpy(), jdx, atol=2.0 ** -7,
                               rtol=2.0 ** -7)
    for a, b in zip([_hwio(d) for d in dws] + [d.numpy() for d in dbs],
                    list(jdws) + list(jdbs)):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 2.0 ** -6 * np.abs(b).max()


def test_slope_branch_at_exactly_zero():
    """Saved activations that are exactly 0 take the slope branch, as in
    the Pallas kernel; autograd's leaky_relu would take 1."""
    shape, gc = (1, 8, 8, 128), 8
    x, g, ws, _ = _inputs(4, shape, gc)
    xt, gt, wt = torch.from_numpy(x), torch.from_numpy(g), _packed(ws)
    acts = [torch.zeros(1, gc, 8, 128) for _ in range(4)]
    acts[1][:, :, ::2] = 1.0          # some rows positive, the rest 0
    dx, dws, dbs = dense_block_bwd_plain(xt, acts, wt, gt, res_scale=0.2,
                                         slope=0.2)
    with pltpu.force_tpu_interpret_mode():
        jdx, jdws, jdbs = fused_dense_block_cf5_bwd(
            jnp.asarray(x), [jnp.asarray(a.numpy()) for a in acts],
            [jnp.asarray(w) for w in ws], jnp.asarray(g), rows=8,
            res_scale=0.2, slope=0.2)
    _assert_grads((dx.numpy(), [_hwio(d) for d in dws],
                   [d.numpy() for d in dbs]), (jdx, jdws, jdbs))
    # and it is the slope branch that was taken: with leak = 1 at zero
    # db_1 would be 5x as large
    dfe = torch.zeros(1, 8 + 4 * gc, 8, 128)
    dfe[:, :8] = gt
    for k in (4, 3, 2, 1):
        c_k = 8 + k * gc
        dz = gt * 0.2 if k == 4 else dfe[:, c_k:c_k + gc] * torch.where(
            acts[k] > 0, 1.0, 0.2)
        dfe[:, :c_k] += torch.nn.functional.conv_transpose2d(
            dz, unpack_weight(wt[k]), padding=1)
    np.testing.assert_allclose(dbs[0].numpy(),
                               0.2 * dfe[:, 8:8 + gc].sum((0, 2, 3)).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_save_acts_matches_pallas():
    """``save_acts`` against the JAX kernel's saved activations (the
    counterpart of tests/test_pallas.py
    test_fused_dense_block_cf5_save_acts)."""
    x, _, ws, bs = _inputs(5, (1, 16, 24, 16), 8)
    xt, wt = torch.from_numpy(x), _packed(ws)
    bt = [torch.from_numpy(b) for b in bs]
    y, acts = dense_block_plain(xt, wt, bt, res_scale=0.2, slope=0.2,
                                save_acts=True)
    with pltpu.force_tpu_interpret_mode():
        jy, *jacts = fused_dense_block_cf5(
            jnp.asarray(x), [jnp.asarray(w) for w in ws],
            [jnp.asarray(b) for b in bs], rows=8, save_acts=True)
    jacts = jacts[0] if len(jacts) == 1 else jacts
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert len(acts) == len(jacts) == 4
    for a, b in zip(acts, jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    # the wrapper's buffer is the same activations, channels-last
    y2, feats = dense_block(xt, wt, bt, res_scale=0.2, slope=0.2,
                            save_acts=True)
    assert torch.equal(y2, y) and feats.shape == (1, 24, 16, 16 + 4 * 8)
    x2, acts2 = split_features(feats, 16, 8)
    assert torch.equal(x2, xt)
    assert all(torch.equal(a, b) for a, b in zip(acts, acts2))
    assert torch.equal(feature_buffer(x2, acts2), feats)


def test_bwd_plain_finite_differences():
    """The plain backward against central differences of the plain
    forward in float32.  Loose tolerance (5e-2 of each gradient's
    largest value): float32 differences with eps 1e-2 carry a few
    percent of noise, and a kink of LeakyReLU may lie inside a step."""
    x, g, ws, bs = _inputs(6, (1, 8, 6, 6), 8, scale=0.2)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    wt, bt = _packed(ws), [torch.from_numpy(b) for b in bs]
    kw = dict(res_scale=0.2, slope=0.2)
    _, acts = dense_block_plain(xt, wt, bt, save_acts=True, **kw)
    dx, dws, dbs = dense_block_bwd_plain(xt, acts, wt, gt, **kw)

    def f(xv, wv, bv):
        return float((dense_block_plain(xv, wv, bv, **kw).double()
                      * gt.double()).sum())

    rng = np.random.default_rng(0)
    eps = 1e-2
    for tensor, grad, slot in ((xt, dx, None), (wt[0], dws[0], 0),
                               (wt[4], dws[4], 4), (bt[2], dbs[2], 2)):
        for _ in range(4):
            idx = tuple(int(rng.integers(0, n)) for n in tensor.shape)
            vals = []
            for sign in (1, -1):
                t = tensor.clone()
                t[idx] += sign * eps
                if slot is None:
                    vals.append(f(t, wt, bt))
                elif tensor.dim() == 3:
                    vals.append(f(xt, wt[:slot] + [t] + wt[slot + 1:], bt))
                else:
                    vals.append(f(xt, wt, bt[:slot] + [t] + bt[slot + 1:]))
            fd = (vals[0] - vals[1]) / (2 * eps)
            assert abs(fd - float(grad[idx])) <= \
                5e-2 * float(grad.abs().max()), (idx, fd, float(grad[idx]))


def test_train_returns_dw_in_the_weights_dtype():
    """bf16 weights inside the graph: the fp32 parameter behind them
    receives the gradient rounded to bf16, as the JAX VJP casts it."""
    x, tgt, ws, bs = _inputs(7, (1, 16, 8, 8), 8)
    params = [torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
              .requires_grad_(True) for w in ws]
    packed = [pack_weight(p).to(torch.bfloat16) for p in params]
    bt = [torch.from_numpy(b).requires_grad_(True) for b in bs]
    y = dense_block_train(torch.from_numpy(x).bfloat16(), packed, bt,
                          res_scale=0.2, slope=0.2)
    grads = torch.autograd.grad(y.float().sum(), params + bt)
    for gp in grads[:5]:
        assert gp.dtype == torch.float32
        assert torch.equal(gp, gp.bfloat16().float())
    assert all(gb.dtype == torch.float32 for gb in grads[5:])


def test_wgrad_parts_depends_on_shapes_only():
    assert wgrad_parts(144, 192, True) == 44      # 6 chunks of 32
    assert wgrad_parts(144, 64, True) == 132
    assert wgrad_parts(3, 64, True) == 3          # never more than tiles
    assert wgrad_parts(144, 64, False) == 66      # f32: chunks of 16


def test_forward_entry_refuses_inputs_that_require_grad():
    """dense_block has no gradient: it raises instead of returning a y
    that silently carries none; dense_block_train is the entry that
    has one."""
    x, _, ws, bs = _inputs(11, (1, 16, 8, 8), 8)
    xt = torch.from_numpy(x)
    wt = [w.requires_grad_(True) for w in _packed(ws)]
    bt = [torch.from_numpy(b) for b in bs]
    with pytest.raises(RuntimeError, match="dense_block_train"):
        dense_block(xt, wt, bt, res_scale=0.2, slope=0.2)
    with torch.no_grad():
        y = dense_block(xt, wt, bt, res_scale=0.2, slope=0.2)
    y2 = dense_block_train(xt, wt, bt, res_scale=0.2, slope=0.2)
    assert y2.requires_grad and torch.equal(y, y2.detach())

