"""The residual add and LayerNorm of SwinIR's token stream
(``ops/add_layernorm.py``) on the CPU: the plain version against
PyTorch's add and ``F.layer_norm``, the input checks, and the model
restructured around it against the forward it replaced, bit for bit (the
CPU runs PyTorch's own ops in the same order).  The kernel itself runs
on the card only (``tests/test_torch_cuda.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.config import SwinIRConfig
from super_resolution_tpu_torch.device import no_tf32
from super_resolution_tpu_torch.metrics import recording, span_report
from super_resolution_tpu_torch.models.swinir import (
    BEFORE_UPSAMPLE_SLOPE,
    LN_EPS,
    WINDOW,
    SwinIR,
)
from super_resolution_tpu_torch.models.tail import upsample_tail
from super_resolution_tpu_torch.ops.add_layernorm import (
    add_layernorm,
    add_layernorm_plain,
)
from super_resolution_tpu_torch.ops.window_attention import window_attention

SMALL = SwinIRConfig(embed_dim=60, depths=(2, 3), num_heads=(2, 2))


def _rows(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dtype)
    branch = torch.randn(shape, generator=gen).to(dtype)
    weight = (1 + 0.3 * torch.randn(c, generator=gen)).to(dtype)
    bias = (0.2 * torch.randn(c, generator=gen)).to(dtype)
    return x, branch, weight, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [240, 180, 60])
def test_plain_is_the_add_then_layer_norm(dtype, c):
    x, branch, weight, bias = _rows((2, 5, 7, c), dtype, c)
    s, h = add_layernorm(x, branch, weight, bias, LN_EPS)
    want = x + branch
    assert s.dtype == h.dtype == dtype
    assert torch.equal(s, want)
    assert torch.equal(h, F.layer_norm(want, (c,), weight, bias, LN_EPS))
    alone = add_layernorm(x, None, weight, bias, LN_EPS)
    assert torch.equal(alone, F.layer_norm(x, (c,), weight, bias, LN_EPS))
    assert torch.equal(alone, add_layernorm_plain(x, None, weight, bias,
                                                  LN_EPS))


@pytest.mark.parametrize("case", ["c_not_multiple_of_4", "c_too_wide",
                                  "x_not_contiguous",
                                  "branch_not_contiguous", "branch_shape",
                                  "weight_shape"])
def test_wrapper_raises(case):
    x, branch, weight, bias = _rows((3, 8, 64), torch.float32, 1)
    if case == "c_not_multiple_of_4":
        x, branch = x[..., :62].contiguous(), branch[..., :62].contiguous()
        weight, bias = weight[:62], bias[:62]
        match = "multiple of 4"
    elif case == "c_too_wide":
        x = branch = torch.zeros(2, 1028)
        weight, bias = torch.ones(1028), torch.zeros(1028)
        match = "multiple of 4"
    elif case == "x_not_contiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
        match = "x is not"
    elif case == "branch_not_contiguous":
        branch = branch.transpose(0, 1).contiguous().transpose(0, 1)
        match = "branch is not"
    elif case == "branch_shape":
        branch = branch[:2]
        match = "not x's shape"
    else:
        weight = weight[:32]
        match = r"weight must be \(64,\)"
    with recording():
        with pytest.raises(ValueError, match=match):
            add_layernorm(x, branch, weight, bias, LN_EPS)
        counters = span_report()["counters"]
    assert "add_layernorm.calls" not in counters


def _forward_before_the_fusion(model, x):
    """SwinIR's forward as ``models/swinir.py`` computed it before the
    adds and LayerNorms went into ``add_layernorm``: every LayerNorm
    ``F.layer_norm`` of the stream, every add a plain add.  The oracle
    of the restructure."""
    cfg, e = model.cfg, (model.cfg.embed_dim,)
    b, h, w, _ = x.shape
    ph, pw = -h % WINDOW, -w % WINDOW
    with no_tf32():
        if ph or pw:
            x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                      mode="reflect").permute(0, 2, 3, 1)
        x = x.to(model._dtype).contiguous()
        fea = model.conv_first(x)
        t = F.layer_norm(fea, e, *model._ln["patch"], LN_EPS)
        for rstb in model.layers:
            u = t
            for layer in rstb.residual_group.blocks:
                p = layer._p
                hn = F.layer_norm(u, e, *p["n1"], LN_EPS)
                a = window_attention(F.linear(hn, *p["qkv"]), p["table"],
                                     layer.heads, layer.shift)
                u = u + F.linear(a, *p["proj"])
                hn = F.layer_norm(u, e, *p["n2"], LN_EPS)
                w1, b1, w2, b2 = p["mlp"]
                u = u + F.linear(F.gelu(F.linear(hn, w1, b1)), w2, b2)
            t = t + rstb.conv(u)
        t = F.layer_norm(t, e, *model._ln["norm"], LN_EPS)
        fea = model.conv_after_body(t) + fea
        fea = model.conv_before_upsample[0](fea, act=True,
                                            slope=BEFORE_UPSAMPLE_SLOPE)
        out = upsample_tail(fea.permute(0, 3, 1, 2), model.ups(),
                            model.conv_hr, model.conv_last,
                            slope=cfg.lrelu_slope, kernel=True)
    s = cfg.scale
    return out[:, :, :h * s, :w * s].float().permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(20, 28), (16, 8)])
def test_swinir_is_the_forward_before_the_fusion(dtype, h, w):
    """The restructured forward on the CPU, bit for bit, in float32 and
    in bf16 (LayerNorm weights drawn away from 1 and 0, so a LayerNorm
    with another's parameters would show), with 2·Σ depths + 2 calls."""
    model = SwinIR(SMALL, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    model.prepare(dtype)
    x = torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(h)) \
        - 0.45
    with torch.inference_mode():
        want = _forward_before_the_fusion(model, x)
        with recording():
            got = model(x)
            counters = span_report()["counters"]
    assert torch.equal(got, want)
    assert counters["add_layernorm.calls"] == 2 * 5 + 2
    assert counters["add_layernorm.fused"] == 2 * 5
    assert counters["launches.add_layernorm"] == 0    # the plain version


def test_swinir_l_counts_110_calls_108_with_a_branch():
    """SwinIR-L (9 RSTB of 6 layers): 54 attention adds read by norm2,
    45 MLP adds read by the next norm1, 9 RSTB residuals read by the next
    RSTB's norm1 or by ``norm``; ``patch_embed.norm`` and the first
    norm1 without a branch."""
    model = SwinIR(SwinIRConfig()).prepare(torch.float32)
    with torch.inference_mode(), recording():
        model(torch.rand(1, 8, 8, 3) - 0.45)
        counters = span_report()["counters"]
    assert counters["add_layernorm.calls"] == 110
    assert counters["add_layernorm.fused"] == 108
