"""SwinIR ×4 for real-world super-resolution in PyTorch: NHWC in and out.

SwinIR (Liang et al., arXiv 2108.10257), the 'nearest+conv' upsampler
with the '3conv' residual connection, as ``main_test_swinir.py`` builds
it for ``real_sr`` (the defaults of :class:`config.SwinIRConfig` are
SwinIR-L).  Module names are the released checkpoint's, so its state
dict, less the buffers ``relative_position_index`` and ``attn_mask``
(:func:`import_torch.import_swinir`), loads with ``strict=True``:

- reflect-pad H and W up to multiples of the window (8,
  :data:`ops.window_attention.WINDOW`), cropped at the
  end to ×4 the input (the caller normalises: x − the DIV2K mean);
- ``conv_first`` 3×3 3 → E; ``patch_embed.norm`` LayerNorm; the RSTBs
  ``layers.{i}``; ``norm``; ``conv_after_body`` ('3conv') plus the
  ``conv_first`` output; ``conv_before_upsample.0`` 3×3 E → 64 with
  LeakyReLU 0.01; the tail of :mod:`models.tail` (RRDBNet's): nearest ×2
  and ``conv_up1``, ``conv_up2``, each LeakyReLU 0.2, ``conv_hr`` with
  LeakyReLU 0.2, ``conv_last``;
- RSTB: ``residual_group.blocks.{j}``, Swin layers with cyclic shift 0
  and 4 in turn, then ``conv`` ('3conv': 3×3 E → E/4, LeakyReLU 0.2,
  1×1, LeakyReLU 0.2, 3×3 E/4 → E) plus the RSTB's input;
- Swin layer: x + proj(window attention(norm1(x))), then
  x + fc2(GELU(fc1(norm2(x)))), GELU the exact erf form, LayerNorm eps
  1e-5; the attention is :func:`ops.window_attention.window_attention`
  on the qkv Linear's channels-last output.

Every residual add that a LayerNorm reads next (each layer's attention
add, read by its ``norm2``; each MLP add but an RSTB's last, read by the
next layer's ``norm1``; each RSTB's residual, read by the next RSTB's
first ``norm1`` or by ``norm``) is one
:func:`ops.add_layernorm.add_layernorm` call with that LayerNorm's
parameters: 2·Σ depths of them a forward, 108 in SwinIR-L.  So the
branch rides along with the stream until the next LayerNorm adds it
(:meth:`SwinIR._trunk`, which holds both in one frame so that no tensor
outlives its last reader).  ``patch_embed.norm`` and the first ``norm1``
run back to back through the same call without a branch; the RSTBs'
last MLP adds and ``conv_after_body`` + ``conv_first`` output, which
convs read, stay plain adds.

The map stays channels-last (B, H, W, C) throughout, which is also
SwinIR's token layout.  Every 3×3 conv runs :func:`ops.conv3x3.conv3x3`
(the single-conv kernel on the card; on the tail through
:meth:`models.rrdb.Conv3x3.cf`), the 1×1 conv is a Linear, and the
'3conv' stacks' E/4 = 60 channels are padded to 64 with zero weights and
biases when the model is prepared, so no call pads or copies.  Each
layer's MLP branch, fc1, GELU and fc2, is one
:func:`ops.swin_mlp.swin_mlp` call, which keeps the hidden on chip; its
weights are laid out for the kernel when the model is prepared
(:func:`ops.swin_mlp.kernel_weights`: E 60 and 180 padded to 64 and
184); qkv and proj are PyTorch's Linears in the compute dtype.  On CPU
tensors every kernel's plain version runs (for the adds, LayerNorms and
MLPs PyTorch's own ops); in float32 with TF32 off.

:meth:`SwinIR.prepare` casts to the compute dtype and packs once, after
the weights are loaded, and on the card builds the kernels.
Inference only.  While recording (:mod:`metrics`) each RSTB is the
device span ``swinir.rstb`` and the reflect pad counts its LR pixels in
``swinir.pad_px``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from super_resolution_tpu_torch.config import SwinIRConfig
from super_resolution_tpu_torch.device import no_tf32
from super_resolution_tpu_torch.metrics import count, span
from super_resolution_tpu_torch.models.rrdb import Conv3x3
from super_resolution_tpu_torch.models.tail import upsample_tail
from super_resolution_tpu_torch.ops.add_layernorm import add_layernorm
from super_resolution_tpu_torch.ops.conv3x3 import conv3x3
from super_resolution_tpu_torch.ops.dense_block import pack_weight
from super_resolution_tpu_torch.ops.swin_mlp import kernel_weights, swin_mlp
from super_resolution_tpu_torch.ops.window_attention import (
    TABLE_ROWS,
    WINDOW,
    window_attention,
)

LN_EPS = 1e-5
BEFORE_UPSAMPLE_SLOPE = 0.01    # nn.LeakyReLU's default
CONV_SLOPE = 0.2                # the '3conv' stacks'


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


class _Conv(nn.Module):
    """A k×k conv (k 3 or 1) with OIHW float32 ``weight`` and ``bias`` on
    a channels-last (B, H, W, C) map; run at padded widths (zero weights
    and biases) once prepared."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self._w = self._b = None

    def prepare(self, dtype: torch.dtype, cin: Optional[int] = None,
                cout: Optional[int] = None) -> None:
        w, b = self.weight.detach(), self.bias.detach()
        cout_p, cin_p = cout or w.shape[0], cin or w.shape[1]
        w = F.pad(w, (0, 0, 0, 0, 0, cin_p - w.shape[1], 0,
                      cout_p - w.shape[0]))
        b = F.pad(b, (0, cout_p - b.shape[0]))
        if w.shape[-1] == 3:      # the kernel's packing, float32 bias
            self._w, self._b = pack_weight(w).to(dtype), b.float()
        else:
            self._w = w[:, :, 0, 0].to(dtype).contiguous()
            self._b = b.to(dtype)

    def forward(self, x: torch.Tensor, act: bool = False,
                slope: float = CONV_SLOPE) -> torch.Tensor:
        if self._w.dim() == 3:
            return conv3x3(x, self._w, self._b, act=act, slope=slope)
        y = F.linear(x, self._w, self._b)
        return F.leaky_relu(y, slope) if act else y


class _ThreeConv(nn.Sequential):
    """'3conv': 3×3 E → E/4, LeakyReLU 0.2, 1×1, LeakyReLU 0.2, 3×3
    E/4 → E (indices 0..4, SwinIR's ``nn.Sequential``); E/4 padded to a
    multiple of 8 once prepared."""

    def __init__(self, dim: int):
        q = dim // 4
        super().__init__(_Conv(dim, q), nn.LeakyReLU(CONV_SLOPE),
                         _Conv(q, q, 1), nn.LeakyReLU(CONV_SLOPE),
                         _Conv(q, dim))

    def prepare(self, dtype: torch.dtype) -> None:
        q = _pad8(self[0].weight.shape[0])
        self[0].prepare(dtype, cout=q)
        self[2].prepare(dtype, cin=q, cout=q)
        self[4].prepare(dtype, cin=q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self[0](x, act=True)
        return self[4](self[2](y, act=True))


class _Attention(nn.Module):
    """SwinIR's ``WindowAttention`` parameters: the relative-position
    table ((2w−1)², heads), ``qkv`` and ``proj``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(TABLE_ROWS, heads))
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


def _cast(module: nn.Module, dtype: torch.dtype):
    return module.weight.detach().to(dtype), module.bias.detach().to(dtype)


class SwinLayer(nn.Module):
    """One Swin layer (``SwinTransformerBlock``) on a (B, Hp, Wp, C)
    map: its parameters and its two branches; :meth:`SwinIR._trunk` adds
    them to the stream."""

    def __init__(self, dim: int, heads: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.heads, self.shift = heads, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self._p = None

    def prepare(self, dtype: torch.dtype) -> None:
        table = self.attn.relative_position_bias_table.detach()
        self._p = {"n1": _cast(self.norm1, dtype),
                   "qkv": _cast(self.attn.qkv, dtype),
                   "proj": _cast(self.attn.proj, dtype),
                   "n2": _cast(self.norm2, dtype),
                   "mlp": kernel_weights(*_cast(self.mlp.fc1, dtype),
                                         *_cast(self.mlp.fc2, dtype)),
                   "table": table.t().float().contiguous()}

    def branches(self) -> tuple:
        """((norm1's (weight, bias), the attention branch), (norm2's, the
        MLP branch)): the layer's two residual branches in turn, each a
        function of its LayerNorm's output that is added back into the
        stream."""
        return (self._p["n1"], self._attention), (self._p["n2"], self._mlp)

    def _attention(self, h: torch.Tensor) -> torch.Tensor:
        p = self._p
        a = window_attention(F.linear(h, *p["qkv"]), p["table"], self.heads,
                             self.shift)
        return F.linear(a, *p["proj"])

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        return swin_mlp(h, *self._p["mlp"])


class _Group(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.blocks = nn.ModuleList(layers)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: Swin layers (shift 0, w/2 in
    turn), '3conv', plus the input (run by :meth:`SwinIR._trunk`)."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.residual_group = _Group(
            [SwinLayer(dim, heads, 0 if j % 2 == 0 else WINDOW // 2,
                       mlp_ratio) for j in range(depth)])
        self.conv = _ThreeConv(dim)


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


def _trunc_normal_(t: torch.Tensor, std: float,
                   generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.nn.init.trunc_normal_(torch.empty_like(t), std=std,
                                            a=-2.0, b=2.0,
                                            generator=generator))


def _conv_default_(weight: torch.Tensor, bias: torch.Tensor,
                   generator: torch.Generator) -> None:
    """nn.Conv2d's default: U(−1/√fan_in, 1/√fan_in) for weight and bias."""
    bound = (weight.shape[1] * weight.shape[2] * weight.shape[3]) ** -0.5
    with torch.no_grad():
        for t in (weight, bias):
            t.copy_(torch.rand(t.shape, generator=generator) * 2 * bound
                    - bound)


class SwinIR(nn.Module):
    """SwinIR ×4 ('nearest+conv', '3conv').  ``forward`` takes and returns
    NHWC float32 in normalised space (x − the DIV2K mean); weights are
    drawn from ``generator`` (seed 0 when None) by SwinIR's
    ``_init_weights``: Linears trunc-normal std 0.02 with zero biases,
    LayerNorms 1 and 0, tables trunc-normal std 0.02, convs nn.Conv2d's
    default."""

    def __init__(self, cfg: SwinIRConfig = SwinIRConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        e, nf = cfg.embed_dim, cfg.num_feat
        self.conv_first = _Conv(cfg.channels, e)
        self.patch_embed = _PatchEmbed(e)
        self.layers = nn.ModuleList(
            [RSTB(e, d, h, cfg.mlp_ratio)
             for d, h in zip(cfg.depths, cfg.num_heads)])
        self.norm = nn.LayerNorm(e, eps=LN_EPS)
        self.conv_after_body = _ThreeConv(e)
        self.conv_before_upsample = nn.Sequential(
            _Conv(e, nf), nn.LeakyReLU(BEFORE_UPSAMPLE_SLOPE))
        for u in range(1, cfg.n_upsample + 1):
            setattr(self, f"conv_up{u}", Conv3x3(nf, nf))
        self.conv_hr = Conv3x3(nf, nf)
        self.conv_last = Conv3x3(nf, cfg.channels)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _trunc_normal_(m.weight, 0.02, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, _Attention):
                _trunc_normal_(m.relative_position_bias_table, 0.02,
                               generator)
            elif isinstance(m, (_Conv, Conv3x3)):
                _conv_default_(m.weight, m.bias, generator)
        self._dtype = self._device = self._ln = None

    def ups(self):
        return [getattr(self, f"conv_up{u}")
                for u in range(1, self.cfg.n_upsample + 1)]

    def prepare(self, dtype: torch.dtype) -> "SwinIR":
        """Cast to the compute dtype and pack the convs' weights, on the
        parameters' device, and there build the attention kernel, the
        add-and-LayerNorm kernel, the MLP kernel and the 3×3 conv's
        together (an RRDB model never builds the first three).  Call after
        loading weights or moving the model; returns self."""
        for m in self.modules():
            if isinstance(m, (SwinLayer, _ThreeConv)):
                m.prepare(dtype)
        self.conv_first.prepare(dtype)
        self.conv_before_upsample[0].prepare(dtype)
        for conv in (*self.ups(), self.conv_hr, self.conv_last):
            conv.prepare(dtype)
        self._ln = {n: _cast(m, dtype) for n, m in
                    (("patch", self.patch_embed.norm), ("norm", self.norm))}
        self._dtype = dtype
        self._device = self.conv_first.weight.device
        if self._device.type == "cuda":
            from super_resolution_tpu_torch.build import load_all

            load_all(("window_attention", "add_layernorm", "swin_mlp",
                      "conv3x3"))
        return self

    def _trunk(self, fea: torch.Tensor) -> torch.Tensor:
        """``norm`` of the RSTBs on ``patch_embed.norm(fea)``.  The stream
        t and the branch y not yet added to it live in this one frame: each
        add is the :func:`ops.add_layernorm.add_layernorm` call of the
        LayerNorm that reads the sum, and every tensor it replaces is
        dropped before the next branch is built."""
        t, y = add_layernorm(fea, None, *self._ln["patch"], LN_EPS), None
        for rstb in self.layers:
            with span("swinir.rstb", fea.device):
                x = None                    # the RSTB's input
                for layer in rstb.residual_group.blocks:
                    for norm, branch in layer.branches():
                        if y is None:       # the first norm1
                            h = add_layernorm(t, None, *norm, LN_EPS)
                        else:
                            t, h = add_layernorm(t, y, *norm, LN_EPS)
                        x = t if x is None else x
                        del y               # in t now: free it first
                        y = branch(h)
                t, y = x, rstb.conv(t + y)
        return add_layernorm(t, y, *self._ln["norm"], LN_EPS)[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._dtype is None:
            raise RuntimeError("SwinIR.prepare(dtype) must run after the "
                               "weights are loaded")
        if x.device != self._device:
            raise RuntimeError(f"input on {x.device}, model prepared on "
                               f"{self._device}")
        cfg = self.cfg
        b, h, w, _ = x.shape
        ph, pw = -h % WINDOW, -w % WINDOW
        count("swinir.pad_px", b * ((h + ph) * (w + pw) - h * w))
        with no_tf32():
            if ph or pw:
                x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                          mode="reflect").permute(0, 2, 3, 1)
            x = x.to(self._dtype).contiguous()
            fea = self.conv_first(x)
            fea = self.conv_after_body(self._trunk(fea)) + fea
            fea = self.conv_before_upsample[0](fea, act=True,
                                               slope=BEFORE_UPSAMPLE_SLOPE)
            out = upsample_tail(fea.permute(0, 3, 1, 2), self.ups(),
                                self.conv_hr, self.conv_last,
                                slope=cfg.lrelu_slope, kernel=True)
        s = cfg.scale
        return out[:, :, :h * s, :w * s].float().permute(0, 2, 3, 1)
