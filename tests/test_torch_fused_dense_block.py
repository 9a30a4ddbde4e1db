"""The port's NHWC dense-block entry
(``super_resolution_tpu_torch.ops.dense_block.fused_dense_block``)
against the JAX package's Pallas kernel ``ops/pallas/dense_block.py:
fused_dense_block`` in interpret mode, and, at a height the JAX package
does not give that kernel (H % 8 != 0), against its ``DenseBlock`` under
``conv_impl="pallas_fused"``, which then runs the convs one by one on
lax.  Inputs and weights are drawn with numpy from a seed.

Tolerances: float32 at atol 2e-5, rtol 1e-4, the Pallas kernels' own
against lax (``tests/test_pallas.py``); the port sums the taps in
another order.  bfloat16 at atol = rtol = 2**-5: the Pallas kernel
rounds each tap's partial product to bf16 before its f32 tap sum (a VMEM
saving on the TPU) and the port does not, so beside the usual one-ULP
flips of each conv's rounding, which later convs carry, every conv
output differs by that rounding too (measured at most 2**-6 on these
inputs, one ULP of the largest outputs).  The interpreted kernel runs
as one jitted call, read back before anything else is dispatched (see
``test_torch_conv3x3.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from super_resolution_tpu.config import GeneratorConfig as JaxGeneratorConfig
from super_resolution_tpu.models.rrdb import DenseBlock as JaxDenseBlock
from super_resolution_tpu.ops.pallas.dense_block import (
    fused_dense_block as j_fused_dense_block,
)
from super_resolution_tpu_torch.ops.dense_block import (
    LAUNCHES_PER_BLOCK,
    dense_block,
    fused_dense_block,
    pack_weight,
)

from test_torch_dense_block import GC, NF, _block_inputs

TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2.0 ** -5, 2.0 ** -5)}


def _port(x, ws, bs, dtype="float32"):
    """The NHWC entry on NHWC numpy x (``_block_inputs`` draws any
    shape), HWIO weights packed."""
    tdt = getattr(torch, dtype)
    wt = [pack_weight(torch.from_numpy(w).permute(3, 2, 0, 1)).to(tdt)
          for w in ws]
    y = fused_dense_block(torch.from_numpy(x).to(tdt), wt,
                          [torch.from_numpy(b) for b in bs], res_scale=0.2,
                          slope=0.2)
    assert y.dtype == tdt and y.is_contiguous()
    return y.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rows", [
    ((1, 16, 16, NF), 8),       # three input blocks per band (rows < 10)
    ((2, 32, 24, NF), 16),      # two
], ids=["rows8", "rows16"])
def test_nhwc_block_matches_pallas(shape, rows, dtype):
    x, ws, bs = _block_inputs(0, shape)
    jdt = getattr(jnp, dtype)

    def block(x_, ws_, bs_):
        return j_fused_dense_block(x_.astype(jdt),
                                   [w.astype(jdt) for w in ws_], bs_,
                                   rows=rows, res_scale=0.2, slope=0.2)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(block)(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                             [jnp.asarray(b) for b in bs])
        ref = np.asarray(ref).astype(np.float32)
    got = _port(x, ws, bs, dtype)
    assert got.shape == ref.shape == shape
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


def test_odd_height_matches_the_jax_fallback():
    """H = 13: the JAX DenseBlock under pallas_fused falls back to
    per-conv lax; the port's kernel takes the height, float32."""
    x, ws, bs = _block_inputs(1, (1, 13, 20, NF))
    cfg = dataclasses.replace(JaxGeneratorConfig(filters=NF, growth=GC),
                              conv_impl="pallas_fused")
    params = {f"conv{k + 1}": {"kernel": jnp.asarray(w),
                               "bias": jnp.asarray(b)}
              for k, (w, b) in enumerate(zip(ws, bs))}
    ref = np.asarray(JaxDenseBlock(cfg, jnp.float32).apply(
        {"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_port(x, ws, bs), ref, atol=2e-5, rtol=1e-4)


def test_nhwc_entry_equals_the_nchw_entry_and_counts_nothing_on_cpu():
    x, ws, bs = _block_inputs(2, (2, 9, 11, NF))
    wt = [pack_weight(torch.from_numpy(w).permute(3, 2, 0, 1)) for w in ws]
    bt = [torch.from_numpy(b) for b in bs]
    before = fused_dense_block.launches, dense_block.launches
    y = fused_dense_block(torch.from_numpy(x), wt, bt, res_scale=0.2,
                          slope=0.2)
    y_cf = dense_block(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                       wt, bt, res_scale=0.2, slope=0.2)
    assert torch.equal(y, y_cf.permute(0, 2, 3, 1))
    assert (fused_dense_block.launches, dense_block.launches) == before
    assert LAUNCHES_PER_BLOCK == 5


@pytest.mark.parametrize("bad", ["layout", "channels"])
def test_nhwc_entry_rejects_what_the_kernel_does_not_take(bad):
    x, ws, bs = _block_inputs(3, (1, 8, 8, NF))
    xt = torch.from_numpy(x)
    wt = [pack_weight(torch.from_numpy(w).permute(3, 2, 0, 1)) for w in ws]
    if bad == "layout":
        xt = xt.permute(0, 3, 1, 2)          # an NCHW view: not NHWC
    else:
        xt = torch.zeros(1, 8, 8, 24)        # 24 channels, weights for 16
    with pytest.raises((ValueError, TypeError)):
        fused_dense_block(xt, wt, [torch.from_numpy(b) for b in bs],
                          res_scale=0.2, slope=0.2)
