"""The port's single 3×3 conv (``super_resolution_tpu_torch.ops.conv3x3``)
against the JAX package's Pallas kernels ``conv3x3_cf_fwd`` (NCHW) and
``packed_conv3x3`` (NHWC), run in interpret mode on the CPU, and its
training entry against ``jax.grad`` through the JAX ``conv3x3_cf``.

On a CPU tensor the port's wrappers take the plain version: an f32 conv
with the Pallas kernels' rounding point (f32 bias and LeakyReLU, one
rounding to the output dtype).  Inputs and weights are drawn with numpy
from a seed and handed to both sides.

Tolerances: float32 at atol 2e-5, rtol 1e-4 (the two sides sum the taps
in another order; ``tests/test_pallas.py`` holds the kernels to lax so).
bfloat16 at atol 2**-8, rtol 2**-7: one bf16 ULP, since both round the
same f32 sum once and another summation order can flip that rounding.
Gradients in float32 against each tensor's largest value, 1e-5: the
backward is the same lax-style VJP on both sides.

Every JAX computation that reaches an interpreted Pallas kernel runs as
one jitted call whose result is read before anything else is
dispatched: the TPU interpreter dispatches JAX work from its callbacks,
and eager work queued meanwhile from the test's thread can deadlock it.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from super_resolution_tpu.ops.pallas.conv_cf import conv3x3_cf as j_conv3x3_cf
from super_resolution_tpu.ops.pallas.conv_cf import conv3x3_cf_fwd
from super_resolution_tpu.ops.pallas.packed_conv import (
    packed_conv3x3 as j_packed_conv3x3,
)
from super_resolution_tpu_torch.ops.conv3x3 import (
    conv3x3,
    conv3x3_cf,
    conv3x3_cf_train,
    packed_conv3x3,
)
from super_resolution_tpu_torch.ops.dense_block import pack_weight

c3_ops = importlib.import_module("super_resolution_tpu_torch.ops.conv3x3")
TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2.0 ** -8, 2.0 ** -7)}


def _inputs(seed, cin, cout):
    """HWIO weights and an f32 bias, float32 numpy."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((3, 3, cin, cout))
         * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    return w, (rng.standard_normal(cout) * 0.1).astype(np.float32)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _packed(w, dtype):
    """HWIO numpy -> the port's packed (9, cout, cin) weight."""
    oihw = torch.from_numpy(np.array(w)).permute(3, 2, 0, 1)
    return pack_weight(oihw).to(getattr(torch, dtype))


def _interpreted(fn, *args):
    """``fn(*args)`` as one jitted call with the Pallas kernels in
    interpret mode, read back as float32 numpy."""
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(fn)(*map(jnp.asarray, args))
        return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,act", [
    ((1, 16, 16, 24), 16, True),
    ((2, 16, 16, 16), 16, False),
    ((1, 16, 8, 16), 64, True),        # pixelshuffle-like: F = 4 nf
], ids=["act", "no_act", "f64"])
def test_conv3x3_cf_matches_pallas(shape, cout, act, dtype):
    x = _x(0, shape)
    w, b = _inputs(1, shape[1], cout)
    jdt = getattr(jnp, dtype)
    ref = _interpreted(
        lambda x_, w_, b_: conv3x3_cf_fwd(x_.astype(jdt), w_.astype(jdt), b_,
                                          rows=8, act=act, slope=0.2),
        x, w, b)
    y = conv3x3_cf(torch.from_numpy(x).to(getattr(torch, dtype)),
                   _packed(w, dtype), torch.from_numpy(b), act=act,
                   slope=0.2)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert y.dtype == getattr(torch, dtype)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,act", [
    ((2, 16, 12, 32), 32, True),
    ((1, 8, 16, 3), 16, False),        # conv_first: cin 3
    ((1, 16, 8, 64), 3, False),        # conv_last: cout 3
], ids=["act", "cin3", "cout3"])
def test_packed_conv3x3_matches_pallas(shape, cout, act, dtype):
    x = _x(2, shape)
    w, b = _inputs(3, shape[-1], cout)
    jdt = getattr(jnp, dtype)
    ref = _interpreted(
        lambda x_, w_, b_: j_packed_conv3x3(x_.astype(jdt), w_.astype(jdt),
                                            b_, rows=8, apply_act=act,
                                            out_dtype=jdt),
        x, w, b)
    y = packed_conv3x3(torch.from_numpy(x).to(getattr(torch, dtype)),
                       _packed(w, dtype), torch.from_numpy(b),
                       apply_act=act)
    assert y.shape == (*shape[:3], cout) and y.is_contiguous()
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("act", [True, False])
def test_conv3x3_cf_train_grads_match_jax(act):
    """dx, dW and db of sum(y^2) against jax.grad through the JAX custom
    VJP (Pallas forward in interpret mode, lax backward), float32."""
    x = _x(4, (2, 8, 16, 16))
    w, b = _inputs(5, 8, 16)

    def loss(x_, w_, b_):
        return jnp.sum(j_conv3x3_cf(x_, w_, b_, 8, act, 0.2) ** 2)

    jg = _interpreted(jax.grad(loss, argnums=(0, 1, 2)), x, w, b)
    leaves = [torch.from_numpy(x).requires_grad_(True),
              _packed(w, "float32").requires_grad_(True),
              torch.from_numpy(b).requires_grad_(True)]
    y = conv3x3_cf_train(*leaves, act=act, slope=0.2)
    dx, dw, db = torch.autograd.grad(y.square().sum(), leaves)
    assert dx.dtype == dw.dtype == db.dtype == torch.float32
    want = [jg[0], _packed(jg[1], "float32").numpy(), jg[2]]
    for got, ref in zip((dx, dw, db), want):
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                   atol=1e-5, rtol=1e-5)


def test_train_entry_returns_grads_in_the_inputs_dtypes():
    """bf16 x and weights, f32 bias: dx and dW come back bf16, db f32,
    as the JAX VJP returns them."""
    x = torch.from_numpy(_x(6, (1, 8, 8, 8))).bfloat16().requires_grad_(True)
    w_, b_ = _inputs(7, 8, 8)
    w = _packed(w_, "bfloat16").requires_grad_(True)
    b = torch.from_numpy(b_).requires_grad_(True)
    y = conv3x3_cf_train(x, w, b, act=True, slope=0.2)
    grads = torch.autograd.grad(y.float().sum(), (x, w, b))
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.bfloat16,
                                        torch.float32]


def test_slice_in_and_out_equals_a_whole_conv():
    """The ``pallas`` dense block's use: a channel prefix of one buffer
    in, a channel slice of the same buffer out."""
    buf = torch.from_numpy(_x(8, (2, 10, 12, 24)))
    w, b = _inputs(9, 16, 8)
    want = conv3x3(buf[..., :16].contiguous(), _packed(w, "float32"),
                   torch.from_numpy(b), act=False, slope=0.2)
    keep = buf[..., :16].clone()
    got = conv3x3(buf[..., :16], _packed(w, "float32"), torch.from_numpy(b),
                  act=False, slope=0.2, out=buf[..., 16:])
    assert got.data_ptr() == buf[..., 16:].data_ptr()
    assert torch.equal(buf[..., 16:], want)
    assert torch.equal(buf[..., :16], keep)


def test_cpu_path_counts_no_launches_and_converts_nchw_once():
    x = torch.from_numpy(_x(10, (1, 8, 6, 6)))
    w, b = _inputs(11, 8, 8)
    launches, conv0 = conv3x3.launches, conv3x3_cf.conversions
    y = conv3x3_cf(x, _packed(w, "float32"), torch.from_numpy(b))
    assert conv3x3_cf.conversions == conv0 + 1       # contiguous NCHW
    conv3x3_cf(y, _packed(np.zeros((3, 3, 8, 8), np.float32), "float32"),
               torch.from_numpy(b))
    assert conv3x3_cf.conversions == conv0 + 1       # channels-last
    assert conv3x3.launches == launches


@pytest.mark.parametrize("bad", ["packing", "dtype", "bias", "layout",
                                 "out_dtype", "grad"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.from_numpy(_x(12, (1, 6, 6, 8)))
    w_, b_ = _inputs(13, 8, 8)
    w, b = _packed(w_, "float32"), torch.from_numpy(b_)
    kw = dict(act=False, slope=0.2)
    err = (ValueError, TypeError)
    if bad == "packing":
        w = torch.from_numpy(w_)                     # HWIO, not packed
    elif bad == "dtype":
        w = w.bfloat16()
    elif bad == "bias":
        b = b.double()
    elif bad == "layout":
        x = x.transpose(1, 2)                        # not channels-last
    elif bad == "out_dtype":
        kw["out_dtype"] = torch.float16
    else:
        w.requires_grad_(True)
        err = RuntimeError
    with pytest.raises(err):
        c3_ops.conv3x3(x, w, b, **kw)
