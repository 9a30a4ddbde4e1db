"""The polyphase tail (``ops/upsample_conv.py``, ``tail_up="polyphase"``)
against the JAX package's ``ops/upsample_conv.py`` and RRDBNet, on the
CPU, from seeded numpy inputs:

- ``nearest_up_conv`` (NHWC) and ``nearest_up_conv_nchw`` against the
  JAX functions at ``Precision.HIGHEST`` and against the naive form
  (nearest ×2, then a 3×3 SAME conv): float32 at atol 2e-5, rtol 1e-4;
- bfloat16 against the JAX function in bfloat16 within 2^-6 +
  2^-6·|ref|, and the 2×2 kernels' row and column sums rounded where
  the JAX function rounds them, bit for bit;
- the gradients of x, the 3×3 kernel and the bias against ``jax.grad``;
- a small RRDBNet (1 block, 16 / 8) with ``tail_up="polyphase"`` against
  the JAX RRDBNet with the same weights under ``lax``, ``pallas_cf_tail``
  and ``pallas_fused`` (the port's plain versions, the JAX kernels in
  interpret mode, as ``test_torch_conv_impls.py`` runs them), at the G
  tolerances of ``tests/test_parity.py`` (atol 2e-5, rtol 1e-4);
- the live (training) path: the gradient reaches the 3×3 weight and
  equals the naive tail's, and the cached forward equals the live one.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from super_resolution_tpu.config import GeneratorConfig as JaxGeneratorConfig
from super_resolution_tpu.models import RRDBNet as JaxRRDBNet
from super_resolution_tpu.ops import upsample_conv as jax_up
from super_resolution_tpu_torch.config import GeneratorConfig
from super_resolution_tpu_torch.import_torch import state_dict_from_flax
from super_resolution_tpu_torch.models.rrdb import RRDBNet
from super_resolution_tpu_torch.ops.shuffle import nearest_upsample
from super_resolution_tpu_torch.ops.upsample_conv import (
    nearest_up_conv,
    nearest_up_conv_nchw,
    phase_kernels,
)

HIGHEST = jax.lax.Precision.HIGHEST
ATOL, RTOL = 2e-5, 1e-4                  # tests/test_parity.py:45
BF16_TOL = 2.0 ** -6
SMALL = dict(n_blocks=1, filters=16, growth=8, init="torch_default")


def _inputs(seed, b=2, h=7, w=9, c=5, f=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            rng.standard_normal((3, 3, c, f)).astype(np.float32),
            rng.standard_normal(f).astype(np.float32))


def _oihw(k_hwio):
    return torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0,
                                                                  1)))


@pytest.mark.parametrize("layout", ["nhwc", "nchw", "nchw_channels_last"])
def test_matches_jax_and_naive_fp32(layout):
    x, k, b = _inputs(0)
    ref = np.asarray(jax_up.nearest_up_conv(jnp.asarray(x), jnp.asarray(k),
                                            jnp.asarray(b),
                                            precision=HIGHEST))
    w, bt = _oihw(k), torch.from_numpy(b)
    xt = torch.from_numpy(x)
    if layout == "nhwc":
        got = nearest_up_conv(xt, w, bt)
        assert got.is_contiguous()
    else:
        xc = xt.permute(0, 3, 1, 2)
        xc = xc.contiguous() if layout == "nchw" else xc
        y = nearest_up_conv_nchw(xc, w, bt)
        # channels-last out, whatever the input's memory format
        assert y.is_contiguous(memory_format=torch.channels_last)
        got = y.permute(0, 2, 3, 1)
    naive = F.conv2d(nearest_upsample(xt.permute(0, 3, 1, 2), 2), w, bt,
                     padding=1).permute(0, 2, 3, 1)
    assert got.shape == (2, 14, 18, 4)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_nchw_entry_matches_jax_nchw():
    x, k, b = _inputs(1, b=1, h=6, w=4, c=3, f=2)
    xn = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    ref = np.asarray(jax_up.nearest_up_conv_nchw(
        jnp.asarray(xn), jnp.asarray(k), jnp.asarray(b), precision=HIGHEST))
    got = nearest_up_conv_nchw(torch.from_numpy(xn), _oihw(k),
                               torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_bf16_matches_jax_bf16():
    """bf16 x and kernel, f32 bias cast to bf16 after the interleave: the
    two packages differ only in the convs' accumulation order."""
    x, k, b = _inputs(2, b=2, h=8, w=8, c=16, f=8)
    ref = np.asarray(jax_up.nearest_up_conv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(b)).astype(jnp.float32))
    got = nearest_up_conv(torch.from_numpy(x).bfloat16(), _oihw(k),
                          torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    assert (err <= BF16_TOL + BF16_TOL * np.abs(ref)).all(), err.max()


def test_bf16_phase_sums_round_where_jax_rounds():
    """The 3×3 kernel is cast first, then the row sums, then the column
    sums of those are formed, each rounded to bf16: the JAX function's
    order (``ops/upsample_conv.py:49-74``), here written out in jnp."""
    _, k, _ = _inputs(3, c=6, f=5)
    kb = jnp.asarray(k, jnp.bfloat16)                         # HWIO
    rows = {0: (kb[0:1], kb[1:2] + kb[2:3]),
            1: (kb[0:1] + kb[1:2], kb[2:3])}
    want = []
    for a in (0, 1):
        rp, rc = rows[a]
        for c in (0, 1):
            def cols(r):
                if c == 0:
                    return [r[:, 0:1], r[:, 1:2] + r[:, 2:3]]
                return [r[:, 0:1] + r[:, 1:2], r[:, 2:3]]
            k2 = jnp.concatenate([jnp.concatenate(cols(rp), 1),
                                  jnp.concatenate(cols(rc), 1)], 0)
            want.append(np.asarray(k2.astype(jnp.float32))
                        .transpose(3, 2, 0, 1))             # OIHW
    got = phase_kernels(_oihw(k).bfloat16())
    assert got.shape == (4 * 5, 6, 2, 2)
    for g, wnt in zip(got.chunk(4), want):
        np.testing.assert_array_equal(g.float().numpy(), wnt)


def test_gradients_match_jax_grad():
    x, k, b = _inputs(4, b=2, h=5, w=6, c=4, f=3)
    cot = np.random.default_rng(5).standard_normal((2, 10, 12, 3)) \
        .astype(np.float32)

    def loss(x_, k_, b_):
        y = jax_up.nearest_up_conv(x_, k_, b_, precision=HIGHEST)
        return jnp.sum(y * cot)

    gx, gk, gb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    w = _oihw(k).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    (nearest_up_conv(xt, w, bt) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=RTOL)
    np.testing.assert_allclose(w.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(gk), atol=1e-4, rtol=RTOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), atol=1e-4,
                               rtol=RTOL)


def _jax_params(x):
    cfg = JaxGeneratorConfig(conv_impl="lax", tail_up="polyphase", **SMALL)
    params = JaxRRDBNet(cfg).init(jax.random.key(7), x)["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("impl", ["lax", "pallas_cf_tail", "pallas_fused"])
def test_rrdbnet_polyphase_matches_jax(impl):
    x = np.random.default_rng(6).standard_normal((1, 16, 16, 3)) \
        .astype(np.float32)
    params = _jax_params(x)
    jcfg = JaxGeneratorConfig(conv_impl=impl, tail_up="polyphase", **SMALL)
    apply = JaxRRDBNet(jcfg).apply
    if impl == "pallas_fused":
        apply = jax.jit(apply)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(apply({"params": params}, jnp.asarray(x)))
    model = RRDBNet(GeneratorConfig(conv_impl=impl, tail_up="polyphase",
                                    **SMALL))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = model.prepare(torch.float32)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 64, 64, 3)
    assert np.abs(ref).max() > 0.1        # outputs of order 1
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_live_path_gradient_reaches_the_3x3_weight():
    """Training: the 2×2 kernels are formed inside the graph, so the
    gradient reaches ``conv_up{u}.weight`` and equals the naive tail's
    (the same function); the cached forward equals the live one."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 8, 8, 3)).astype(np.float32))
    grads, outs = {}, {}
    for tail in ("naive", "polyphase"):
        model = RRDBNet(GeneratorConfig(tail_up=tail, **SMALL),
                        torch.Generator().manual_seed(3))
        model.prepare(torch.float32, live=True)
        out = model(x)
        out.square().mean().backward()
        grads[tail] = {n: p.grad.clone() for n, p in model.named_parameters()}
        outs[tail] = out.detach()
        if tail == "polyphase":
            with torch.no_grad():
                cached = model.prepare(torch.float32)(x)
            torch.testing.assert_close(cached, outs[tail], atol=1e-6,
                                       rtol=1e-6)
    torch.testing.assert_close(outs["polyphase"], outs["naive"], atol=ATOL,
                               rtol=RTOL)
    for n in grads["naive"]:
        g, ref = grads["polyphase"][n], grads["naive"][n]
        assert float(g.abs().max()) > 0, n
        assert float((g - ref).abs().max()) <= \
            1e-4 * float(ref.abs().max()) + 1e-7, n
