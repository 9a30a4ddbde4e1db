"""The MLP branch of SwinIR's Swin layers (``ops/swin_mlp.py``) on the
CPU: the plain version against PyTorch's three calls, the input checks,
the widths the kernel takes and the card's layout of the weights, the
token counter, and the model's CPU forward with the branch through
:func:`swin_mlp` against the forward written out with ``F.linear``,
``F.gelu``, ``F.linear``, bit for bit.
The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.config import SwinIRConfig
from super_resolution_tpu_torch.metrics import recording, span_report
from super_resolution_tpu_torch.models.swinir import SwinIR
from super_resolution_tpu_torch.ops.swin_mlp import (
    _padded,
    kernel_takes,
    kernel_weights,
    swin_mlp,
    swin_mlp_plain,
)
from test_torch_add_layernorm import _forward_before_the_fusion


def _mlp(e, hidden, dtype, seed, lead=(2, 5, 7)):
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(*lead, e, generator=gen).to(dtype)
    w1 = (torch.randn(hidden, e, generator=gen) * e ** -0.5).to(dtype)
    b1 = (0.3 * torch.randn(hidden, generator=gen)).to(dtype)
    w2 = (torch.randn(e, hidden, generator=gen) * hidden ** -0.5).to(dtype)
    b2 = (0.3 * torch.randn(e, generator=gen)).to(dtype)
    return h, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,hidden", [(240, 480), (60, 120), (180, 360)])
def test_plain_is_linear_gelu_linear(dtype, e, hidden):
    """On the CPU the wrapper is the plain version, and that is PyTorch's
    three calls (GELU's erf form), bit for bit; the tokens counted."""
    h, w1, b1, w2, b2 = _mlp(e, hidden, dtype, e)
    want = F.linear(F.gelu(F.linear(h, w1, b1)), w2, b2)
    with recording():
        got = swin_mlp(h, w1, b1, w2, b2)
        counters = span_report()["counters"]
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(swin_mlp_plain(h, w1, b1, w2, b2), want)
    assert counters["swin_mlp.tokens"] == 2 * 5 * 7
    assert counters["launches.swin_mlp"] == 0


@pytest.mark.parametrize("e,hidden,takes", [
    (240, 480, True),      # SwinIR-L
    (180, 360, True),      # SwinIR-M and the classical models
    (60, 120, True),       # the lightweight model
    (236, 472, True), (100, 203, True), (32, 2048, True), (4, 8, True),
    (244, 488, False), (256, 512, False),   # past fc2's widest N
    (62, 124, False),      # no multiple of 4
    (32, 2049, False),     # b1 past its shared memory
])
def test_kernel_takes_by_width(e, hidden, takes):
    assert kernel_takes(e, hidden) is takes


@pytest.mark.parametrize("e,hidden", [(180, 360), (60, 120), (100, 203),
                                      (240, 480)])
def test_kernel_weights_pad_with_zeros(e, hidden):
    """The card's layout of the weights: W1's rows to E rounded up to 8,
    the hidden width to a multiple of 8, with zeros, so that the padded
    MLP on h padded with zeros is the same function (float64); SwinIR-L's
    widths are not copied.  On the CPU the weights stay as they are."""
    h, w1, b1, w2, b2 = _mlp(e, hidden, torch.float64, e)
    p1, q1, p2, q2 = _padded(w1, b1, w2, b2)
    e8, hidden8 = -(-e // 8) * 8, -(-hidden // 8) * 8
    assert (p1.shape, q1.shape, p2.shape, q2.shape) == (
        (hidden8, e8), (hidden8,), (e, hidden8), (e,))
    assert all(t.is_contiguous() for t in (p1, q1, p2))
    assert torch.equal(p1[:hidden, :e], w1) and torch.equal(q1[:hidden], b1)
    assert torch.equal(p2[:, :hidden], w2) and q2 is b2
    assert not p1[hidden:].any() and not p1[:, e:].any()
    assert not q1[hidden:].any() and not p2[:, hidden:].any()
    if (e8, hidden8) == (e, hidden):
        assert p1 is w1 and q1 is b1 and p2 is w2
    want = F.linear(F.gelu(F.linear(h, w1, b1)), w2, b2)
    got = F.linear(F.gelu(F.linear(F.pad(h, (0, e8 - e)), p1, q1)), p2, q2)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert all(a is b for a, b in zip(kernel_weights(w1, b1, w2, b2),
                                      (w1, b1, w2, b2)))


def test_kernel_weights_raise_for_widths_it_does_not_take():
    """Off the CPU (here the meta device) a width the kernel does not
    take raises when the model is prepared, not at its first call."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="multiple of 4 up to 240"):
        kernel_weights(torch.empty(496, 248, device=meta),
                       torch.empty(496, device=meta),
                       torch.empty(248, 496, device=meta),
                       torch.empty(248, device=meta))
    w1, _, w2, _ = kernel_weights(torch.empty(360, 180, device=meta),
                                  torch.empty(360, device=meta),
                                  torch.empty(180, 360, device=meta),
                                  torch.empty(180, device=meta))
    assert w1.shape == (360, 184) and w2.shape == (180, 360)


@pytest.mark.parametrize("case", ["w1_shape", "b1_shape", "w2_shape",
                                  "b2_shape", "h_not_contiguous",
                                  "w2_not_contiguous"])
def test_wrapper_raises(case):
    h, w1, b1, w2, b2 = _mlp(64, 128, torch.float32, 3)
    match = {"w1_shape": "w1 must be", "b1_shape": "b1 must be",
             "w2_shape": "w2 must be", "b2_shape": "b2 must be",
             "h_not_contiguous": "h is not",
             "w2_not_contiguous": "w2 is not"}[case]
    if case == "w1_shape":
        w1 = w1[:, :32]
    elif case == "b1_shape":
        b1 = b1[:64]
    elif case == "w2_shape":
        w2 = w2[:32]
    elif case == "b2_shape":
        b2 = b2[:32]
    elif case == "h_not_contiguous":
        h = h.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        w2 = w2.t().contiguous().t()
    with recording():
        with pytest.raises(ValueError, match=match):
            swin_mlp(h, w1, b1, w2, b2)
        counters = span_report()["counters"]
    assert "swin_mlp.tokens" not in counters


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swinir_at_240_is_the_forward_written_out(dtype):
    """A model at SwinIR-L's widths (240, 480) takes the wrapper for its
    MLPs; on the CPU its forward is the one written out with PyTorch's
    calls, bit for bit, one MLP call a layer."""
    cfg = SwinIRConfig(embed_dim=240, depths=(1, 1), num_heads=(8, 8))
    model = SwinIR(cfg, torch.Generator().manual_seed(4)).prepare(dtype)
    x = torch.rand(1, 12, 20, 3, generator=torch.Generator()
                   .manual_seed(5)) - 0.45
    with torch.inference_mode():
        want = _forward_before_the_fusion(model, x)
        with recording():
            got = model(x)
            counters = span_report()["counters"]
    assert torch.equal(got, want)
    assert counters["swin_mlp.tokens"] == 2 * 16 * 24    # padded map


def test_swinir_l_counts_54_mlp_calls_of_its_tokens():
    """SwinIR-L on the CPU: every one of its 54 Swin layers runs its MLP
    over every token, so ``swin_mlp.tokens`` is 54 × the LR pixels (a
    map already a multiple of the window), and nothing is launched."""
    model = SwinIR(SwinIRConfig()).prepare(torch.float32)
    with torch.inference_mode(), recording():
        model(torch.rand(1, 8, 16, 3) - 0.45)
        counters = span_report()["counters"]
    assert counters["swin_mlp.tokens"] == 54 * 8 * 16
    assert counters["launches.swin_mlp"] == 0
