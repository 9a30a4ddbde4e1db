"""RRDBNet ×4 generator in PyTorch: NHWC in and out, NCHW inside.

The architecture of the JAX package's ``models/rrdb.py``: a 3×3 conv
stem, ``n_blocks`` Residual-in-Residual Dense Blocks, a trunk conv with
a global residual, two ×2 upsample stages (nearest+conv, or conv+pixel
shuffle), an HR conv and an output conv.  Module names are BasicSR's
(``conv_first``, ``body.{i}.rdb{k}.conv{j}``, ``conv_body``,
``conv_up1``, ``conv_up2``, ``conv_hr``, ``conv_last``), so a BasicSR
``.pth`` loads with ``strict=True``.

Every dense block goes through :func:`ops.dense_block.dense_block` —
the hand-written kernel on CUDA, its plain version on the CPU.  The
stem, trunk and tail convs are ``F.conv2d``, as the JAX package leaves
them to XLA.  As in the JAX package's ``pallas_cf`` path, the model
transposes once at each end and runs NCHW in between.

Parameters are float32.  :meth:`RRDBNet.prepare` casts them to the
compute dtype and packs the dense-block weights into the kernel's layout
once, after the weights are loaded; run it again after changing them.
That cached path is detached and serves inference.  For training,
``prepare(dtype, live=True)`` keeps no cache: every forward casts and
packs the live parameters inside the graph and runs the dense blocks
through :func:`ops.dense_block.dense_block_train`, so gradients reach
the float32 ``weight`` and ``bias``.  In float32 every conv runs with TF32 off (the JAX package pins
``Precision.HIGHEST`` for float32).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from super_resolution_tpu_torch.config import GeneratorConfig
from super_resolution_tpu_torch.device import no_tf32
from super_resolution_tpu_torch.models.initializers import conv_init_
from super_resolution_tpu_torch.ops.dense_block import (
    N_CONVS,
    dense_block,
    dense_block_train,
    pack_weight,
)
from super_resolution_tpu_torch.ops.shuffle import (
    nearest_upsample,
    pixel_shuffle,
)


class Conv3x3(nn.Module):
    """3×3 SAME conv with float32 ``weight`` (OIHW) and ``bias``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self._w = self._b = self._dtype = None

    def prepare(self, dtype: torch.dtype, live: bool = False) -> None:
        self._dtype = dtype
        self._w = None if live else self.weight.detach().to(dtype)
        self._b = None if live else self.bias.detach().to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._w is None:     # live: cast inside the graph
            return F.conv2d(x, self.weight.to(self._dtype),
                            self.bias.to(self._dtype), padding=1)
        return F.conv2d(x, self._w, self._b, padding=1)


class DenseBlock(nn.Module):
    """5-conv dense block with residual scaling; conv k reads the concat
    of the input and every earlier output.  Runs as one kernel call."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        if cfg.n_dense_convs != N_CONVS:
            raise NotImplementedError(
                f"the dense-block kernel runs {N_CONVS} convs, got "
                f"n_dense_convs={cfg.n_dense_convs}")
        self.cfg = cfg
        cin = cfg.filters
        for j in range(1, N_CONVS + 1):
            width = cfg.filters if j == N_CONVS else cfg.growth
            setattr(self, f"conv{j}", Conv3x3(cin, width))
            cin += width
        self._w = self._b = self._dtype = None

    def convs(self):
        return [getattr(self, f"conv{j}") for j in range(1, N_CONVS + 1)]

    def prepare(self, dtype: torch.dtype, live: bool = False) -> None:
        """Pack the weights into the kernel's layout in ``dtype`` and
        keep the biases float32, as the kernel takes them; ``live``
        leaves that to every forward."""
        self._dtype = dtype
        self._w = self._b = None
        if not live:
            self._w = [pack_weight(c.weight.detach()).to(dtype)
                       for c in self.convs()]
            self._b = [c.bias.detach().float().contiguous()
                       for c in self.convs()]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kw = dict(res_scale=self.cfg.res_scale, slope=self.cfg.lrelu_slope)
        if self._w is None:     # live: cast and pack inside the graph
            return dense_block_train(
                x, [pack_weight(c.weight).to(self._dtype)
                    for c in self.convs()],
                [c.bias for c in self.convs()], **kw)
        return dense_block(x, self._w, self._b, **kw)


class RRDB(nn.Module):
    """Residual-in-Residual Dense Block: ``n_dense`` dense blocks and an
    outer residual with the same scaling."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.res_scale = cfg.res_scale
        self.n_dense = cfg.n_dense
        for k in range(1, cfg.n_dense + 1):
            setattr(self, f"rdb{k}", DenseBlock(cfg))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for k in range(1, self.n_dense + 1):
            out = getattr(self, f"rdb{k}")(out)
        return x + self.res_scale * out


class RRDBNet(nn.Module):
    """×`scale` generator.  ``forward`` takes and returns NHWC float32 in
    normalised space; weights are drawn from ``generator`` (a seeded
    ``torch.Generator``; seed 0 when None) with ``cfg.init``."""

    def __init__(self, cfg: GeneratorConfig = GeneratorConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.tail_up != "naive":
            raise NotImplementedError(
                f"tail_up={cfg.tail_up!r} is not ported yet (ROADMAP.md)")
        if cfg.upsampler not in ("nearest_conv", "pixelshuffle"):
            raise ValueError(f"unknown upsampler {cfg.upsampler!r}")
        self.cfg = cfg
        nf = cfg.filters
        self.conv_first = Conv3x3(cfg.channels, nf)
        self.body = nn.Sequential(*[RRDB(cfg) for _ in range(cfg.n_blocks)])
        self.conv_body = Conv3x3(nf, nf)
        up_out = 4 * nf if cfg.upsampler == "pixelshuffle" else nf
        for u in range(1, cfg.n_upsample + 1):
            setattr(self, f"conv_up{u}", Conv3x3(nf, up_out))
        self.conv_hr = Conv3x3(nf, nf)
        self.conv_last = Conv3x3(nf, cfg.channels)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, Conv3x3):
                conv_init_(cfg.init, m.weight, m.bias, generator)
        self._dtype = self._device = None

    def prepare(self, dtype: torch.dtype, live: bool = False) -> "RRDBNet":
        """Cast to the compute dtype and pack the kernel's weights, on the
        parameters' device.  Call after loading weights or moving the
        model; returns self.  ``live=True`` is the training mode: no
        cache, the parameters are cast and packed inside the graph."""
        for m in self.modules():
            if isinstance(m, (Conv3x3, DenseBlock)):
                m.prepare(dtype, live)
        self._dtype = dtype
        self._device = self.conv_first.weight.device
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._dtype is None:
            raise RuntimeError("RRDBNet.prepare(dtype) must run after the "
                               "weights are loaded")
        if x.device != self._device:
            raise RuntimeError(f"input on {x.device}, model prepared on "
                               f"{self._device}")
        cfg = self.cfg
        slope = cfg.lrelu_slope
        with no_tf32():
            x = x.permute(0, 3, 1, 2).to(self._dtype).contiguous()
            fea = self.conv_first(x)
            fea = fea + self.conv_body(self.body(fea))
            for u in range(1, cfg.n_upsample + 1):
                conv = getattr(self, f"conv_up{u}")
                if cfg.upsampler == "nearest_conv":
                    fea = F.leaky_relu(conv(nearest_upsample(fea, 2)), slope)
                else:
                    fea = pixel_shuffle(F.leaky_relu(conv(fea), slope), 2)
            fea = F.leaky_relu(self.conv_hr(fea), slope)
            out = self.conv_last(fea)
        return out.float().permute(0, 2, 3, 1)
