"""RRDBNet ×4 generator in PyTorch: NHWC in and out.

The architecture of the JAX package's ``models/rrdb.py``: a 3×3 conv
stem, ``n_blocks`` Residual-in-Residual Dense Blocks, a trunk conv with
a global residual, two ×2 upsample stages (nearest+conv, or conv+pixel
shuffle), an HR conv and an output conv.  Module names are BasicSR's
(``conv_first``, ``body.{i}.rdb{k}.conv{j}``, ``conv_body``,
``conv_up1``, ``conv_up2``, ``conv_hr``, ``conv_last``), so a BasicSR
``.pth`` loads with ``strict=True``, and the parameters and their
initial values are the same under every ``cfg.conv_impl``, which picks
the conv path as the JAX package's does:

- ``pallas_cf`` (``auto``): NCHW inside, one transpose at each end.
  Every dense block through :func:`ops.dense_block.dense_block` (the
  dense-block kernel); the stem, trunk and tail convs ``F.conv2d``, as
  the JAX package leaves them to XLA.  Prepared (not live) in bf16, the
  whole RRDB trunk runs as one :func:`ops.dense_block.dense_block_chain`,
  the same values with the blocks' feature buffers chained
  (:meth:`RRDBNet.trunk`).
- ``pallas_cf_tail``: ``pallas_cf``, with ``conv_body``, the upsample
  convs and ``conv_hr`` through :func:`ops.conv3x3.conv3x3_cf` (the
  single-conv kernel), LeakyReLU fused where the JAX package fuses it.
  The tail stays in ``torch.channels_last`` memory format from
  ``conv_body`` to ``conv_hr``, the layout the kernel reads and writes;
  ``conv_last`` is ``F.conv2d``.
- ``pallas``: NHWC inside.  Every conv through
  :func:`ops.conv3x3.packed_conv3x3` without activation, rounded to the
  compute dtype; each dense block conv by conv in the JAX order (the
  conv, LeakyReLU in the compute dtype, the concat — here the conv
  writes its channel slice of one buffer — and the residual in the
  compute dtype).
- ``pallas_fused``: NHWC inside.  Every dense block through
  :func:`ops.dense_block.fused_dense_block`; the stem, trunk and tail
  convs ``F.conv2d`` on the channels-last view.
- ``lax``: the JAX package's XLA path, with no kernel of the port.
  Every conv ``F.conv2d`` (cuDNN on the card) with its bias in the
  compute dtype, on the channels-last storage of the NHWC input; each
  dense block conv by conv in the JAX order (the conv, LeakyReLU in the
  compute dtype, the concat, the residual in the compute dtype).

``cfg.tail_up="polyphase"`` (with the ``nearest_conv`` upsampler) runs
each nearest-×2 + ``conv_up{u}`` as four 2×2 convs on the small plane
(:mod:`ops.upsample_conv`, ``F.conv2d``) followed by LeakyReLU in the
compute dtype, under every impl, as the JAX package bypasses its tail
conv paths there: the single-conv kernel then runs only ``conv_body``
and ``conv_hr`` under ``pallas_cf_tail``, and every conv but the two
upconvs under ``pallas``.  The parameters do not change.

On CUDA tensors the kernels launch; on CPU tensors their plain versions
run.  Parameters are float32.  :meth:`RRDBNet.prepare` casts them to
the compute dtype and packs the kernels' weights once, after the
weights are loaded; run it again after changing them.  That cached path
is detached and serves inference.  For training,
``prepare(dtype, live=True)`` keeps no cache: every forward casts and
packs the live parameters inside the graph and runs the dense blocks
through :func:`ops.dense_block.dense_block_train` and the tail kernels
through :func:`ops.conv3x3.conv3x3_cf_train`, so gradients reach the
float32 ``weight`` and ``bias``; under ``lax`` autograd goes through
``F.conv2d``.  ``pallas`` and ``pallas_fused`` have no backward
(``train.steps.training_cfg`` trains them on ``lax``).  In float32
every conv runs with TF32 off (the JAX package pins
``Precision.HIGHEST`` for float32).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from super_resolution_tpu_torch.config import (
    GeneratorConfig,
    resolve_conv_impl,
)
from super_resolution_tpu_torch.device import no_tf32
from super_resolution_tpu_torch.models.initializers import conv_init_
from super_resolution_tpu_torch.ops.conv3x3 import (
    conv3x3_cf,
    conv3x3_cf_train,
    packed_conv3x3,
)
from super_resolution_tpu_torch.ops.dense_block import (
    dense_block,
    dense_block_chain,
    dense_block_train,
    fused_dense_block,
    pack_weight,
)
from super_resolution_tpu_torch.models.tail import upsample_tail
from super_resolution_tpu_torch.ops.upsample_conv import (
    nearest_up_conv_nchw,
    phase_kernels,
)
from super_resolution_tpu_torch.ops.shuffle import (
    nearest_upsample_nhwc,
    pixel_shuffle_nhwc,
)

NHWC_IMPLS = ("pallas", "pallas_fused")   # the model runs NHWC inside
CHAIN_IMPLS = ("pallas_cf", "pallas_cf_tail")   # blocks by dense_block
_DENSE_BLOCK = dense_block   # a check may put another in dense_block's place


class Conv3x3(nn.Module):
    """3×3 SAME conv with float32 ``weight`` (OIHW) and ``bias``.
    ``forward`` is ``F.conv2d`` (bias in the compute dtype); :meth:`cf`
    and :meth:`nhwc` are the single-conv kernel."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self._w = self._b = self._wp = self._bf = self._pk = None
        self._dtype = None

    def prepare(self, dtype: torch.dtype, live: bool = False,
                phases: bool = False) -> None:
        """Cache the weights cast for ``F.conv2d`` and packed for the
        kernel, and with ``phases`` the four 2×2 kernels of
        :meth:`up`; ``live`` leaves all of it to every forward."""
        self._dtype = dtype
        self._w = self._b = self._wp = self._bf = self._pk = None
        if not live:
            w = self.weight.detach()
            self._w, self._b = w.to(dtype), self.bias.detach().to(dtype)
            self._wp = pack_weight(w).to(dtype)
            self._bf = self.bias.detach().float().contiguous()
            if phases:
                self._pk = phase_kernels(self._w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._w is None:     # live: cast inside the graph
            return F.conv2d(x, self.weight.to(self._dtype),
                            self.bias.to(self._dtype), padding=1)
        return F.conv2d(x, self._w, self._b, padding=1)

    def cf(self, x: torch.Tensor, act: bool, slope: float) -> torch.Tensor:
        """The kernel on NCHW ``x``; channels-last out."""
        if self._w is None:     # live: cast and pack inside the graph
            return conv3x3_cf_train(x, pack_weight(self.weight)
                                    .to(self._dtype), self.bias, act=act,
                                    slope=slope)
        return conv3x3_cf(x, self._wp, self._bf, act=act, slope=slope)

    def nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel on NHWC ``x``, no activation (``pallas``)."""
        return packed_conv3x3(x, self._wp, self._bf, apply_act=False,
                              out_dtype=self._dtype)

    def up(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest-×2 upsample then this conv, as four 2×2 convs on the
        small plane (:mod:`ops.upsample_conv`), on NCHW ``x`` in its
        memory format; live: the 3×3 weight is cast and the 2×2 kernels
        formed inside the graph."""
        if self._w is None:
            return nearest_up_conv_nchw(x, self.weight.to(self._dtype),
                                        self.bias)
        return nearest_up_conv_nchw(x, self._w, self._b, self._pk)

    def lax_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """``forward`` on NHWC ``x`` through its channels-last view."""
        return self(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


class DenseBlock(nn.Module):
    """Dense block of ``cfg.n_dense_convs`` convs (``conv1..conv{n}``,
    the last one back to ``filters``) with residual scaling; conv k reads
    the concat of the input and every earlier output.  NCHW in and out
    under the channels-first impls, NHWC under ``pallas`` and
    ``pallas_fused``."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.cfg = cfg
        self.impl = resolve_conv_impl(cfg.conv_impl)
        n = cfg.n_dense_convs
        cin = cfg.filters
        for j in range(1, n + 1):
            width = cfg.filters if j == n else cfg.growth
            setattr(self, f"conv{j}", Conv3x3(cin, width))
            cin += width
        self._w = self._b = self._dtype = None

    def convs(self):
        return [getattr(self, f"conv{j}")
                for j in range(1, self.cfg.n_dense_convs + 1)]

    def prepare(self, dtype: torch.dtype, live: bool = False) -> None:
        """Pack the weights into the kernels' layout in ``dtype`` and
        keep the biases float32, as the kernels take them (under ``lax``
        each conv casts its own); ``live`` leaves that to every
        forward."""
        self._dtype = dtype
        self._w = self._b = None
        if self.impl == "lax":
            for c in self.convs():
                c.prepare(dtype, live)
        elif not live:
            self._w = [pack_weight(c.weight.detach()).to(dtype)
                       for c in self.convs()]
            self._b = [c.bias.detach().float().contiguous()
                       for c in self.convs()]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kw = dict(res_scale=self.cfg.res_scale, slope=self.cfg.lrelu_slope)
        if self.impl == "lax":
            return self._per_conv_lax(x)
        if self.impl == "pallas":
            return self._per_conv_nhwc(x)
        if self.impl == "pallas_fused":
            return fused_dense_block(x, self._w, self._b, **kw)
        if self._w is None:     # live: cast and pack inside the graph
            return dense_block_train(
                x, [pack_weight(c.weight).to(self._dtype)
                    for c in self.convs()],
                [c.bias for c in self.convs()], **kw)
        return dense_block(x, self._w, self._b, **kw)

    def _per_conv_lax(self, x: torch.Tensor) -> torch.Tensor:
        """``lax``: each conv ``F.conv2d``, LeakyReLU and the concat in
        the compute dtype, then the residual in the compute dtype."""
        feats, slope = x, self.cfg.lrelu_slope
        convs = self.convs()
        for k, conv in enumerate(convs):
            out = conv(feats)
            if k < len(convs) - 1:
                feats = torch.cat([feats, F.leaky_relu(out, slope)], 1)
        return x + self.cfg.res_scale * out

    def _per_conv_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """``pallas``: each conv through the single-conv kernel into its
        channel slice of one buffer, then LeakyReLU in place, in the
        compute dtype; the residual in the compute dtype."""
        b, h, w, c = x.shape
        slope = self.cfg.lrelu_slope
        n = len(self._w)
        buf = x.new_empty((b, h, w, c + (n - 1) * self.cfg.growth))
        buf[..., :c].copy_(x)
        cin = c
        for k in range(n - 1):
            cout = self._w[k].shape[1]
            out = buf[..., cin:cin + cout]
            packed_conv3x3(buf[..., :cin], self._w[k], self._b[k],
                           apply_act=False, out=out)
            F.leaky_relu_(out, slope)
            cin += cout
        out = packed_conv3x3(buf, self._w[-1], self._b[-1], apply_act=False)
        return x + self.cfg.res_scale * out


class RRDB(nn.Module):
    """Residual-in-Residual Dense Block: ``n_dense`` dense blocks and an
    outer residual with the same scaling."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.res_scale = cfg.res_scale
        self.n_dense = cfg.n_dense
        for k in range(1, cfg.n_dense + 1):
            setattr(self, f"rdb{k}", DenseBlock(cfg))

    def dense_blocks(self):
        return [getattr(self, f"rdb{k}") for k in range(1, self.n_dense + 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for rdb in self.dense_blocks():
            out = rdb(out)
        return x + self.res_scale * out


class RRDBNet(nn.Module):
    """×`scale` generator.  ``forward`` takes and returns NHWC float32 in
    normalised space; weights are drawn from ``generator`` (a seeded
    ``torch.Generator``; seed 0 when None) with ``cfg.init``."""

    def __init__(self, cfg: GeneratorConfig = GeneratorConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.tail_up not in ("naive", "polyphase"):
            raise ValueError(f"unknown tail_up {cfg.tail_up!r}")
        if cfg.upsampler not in ("nearest_conv", "pixelshuffle"):
            raise ValueError(f"unknown upsampler {cfg.upsampler!r}")
        self.cfg = cfg
        self.impl = resolve_conv_impl(cfg.conv_impl)
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
        self._polyphase = (cfg.tail_up == "polyphase"
                           and cfg.upsampler == "nearest_conv")
        self._dtype = self._device = None

    def prepare(self, dtype: torch.dtype, live: bool = False) -> "RRDBNet":
        """Cast to the compute dtype and pack the kernels' weights, on
        the parameters' device.  Call after loading weights or moving the
        model; returns self.  ``live=True`` is the training mode: no
        cache, the parameters are cast and packed inside the graph."""
        if live and self.impl in NHWC_IMPLS:
            raise NotImplementedError(
                f"conv_impl={self.impl!r} has no backward (nor has it in "
                f"the JAX package); train.steps.training_cfg trains it on "
                f"'lax'")
        # a dense block's convs run from the block's own packed weights
        for m in self.modules():
            if isinstance(m, DenseBlock):
                m.prepare(dtype, live)
        for name, m in self.named_children():
            if isinstance(m, Conv3x3):
                m.prepare(dtype, live, phases=self._polyphase
                          and name.startswith("conv_up"))
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
        with no_tf32():
            x = x.to(self._dtype)
            if self.impl in NHWC_IMPLS:
                return self._forward_nhwc(x.contiguous()).float()
            x = x.permute(0, 3, 1, 2)
            # lax: cuDNN on the channels-last storage; the kernels' paths
            # take contiguous NCHW
            out = self._forward_nchw(x if self.impl == "lax"
                                     else x.contiguous())
        return out.float().permute(0, 2, 3, 1)

    def trunk(self, fea: torch.Tensor) -> torch.Tensor:
        """The RRDB trunk on ``fea`` (NCHW; NHWC under ``pallas`` and
        ``pallas_fused``): ``self.body``, block by block, or where the
        model can see that its dense blocks run prepared in bf16 through
        :func:`ops.dense_block.dense_block` (``pallas_cf``,
        ``pallas_cf_tail``; not live, and no other function put in its
        place in this module), the same values by
        :func:`ops.dense_block.dense_block_chain`."""
        if (self.impl in CHAIN_IMPLS and self._dtype == torch.bfloat16
                and dense_block is _DENSE_BLOCK):
            blocks = [[(d._w, d._b) for d in r.dense_blocks()]
                      for r in self.body]
            if all(w is not None for r in blocks for w, _ in r):
                return dense_block_chain(fea, blocks,
                                         res_scale=self.cfg.res_scale,
                                         slope=self.cfg.lrelu_slope)
        return self.body(fea)

    def _forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        slope = cfg.lrelu_slope
        fea = self.conv_first(x)
        trunk = self.trunk(fea)
        kernel = self.impl == "pallas_cf_tail"
        if kernel:
            # channels-last from here to conv_hr: the kernel's layout
            fea = self.conv_body.cf(trunk, False, slope) + fea
        else:
            fea = fea + self.conv_body(trunk)
        return upsample_tail(
            fea, [getattr(self, f"conv_up{u}")
                  for u in range(1, cfg.n_upsample + 1)],
            self.conv_hr, self.conv_last, slope=slope, kernel=kernel,
            polyphase=self._polyphase, upsampler=cfg.upsampler)

    def _forward_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """``pallas`` and ``pallas_fused``: NHWC throughout; LeakyReLU in
        the compute dtype after each tail conv, as the JAX package's
        non-channels-first branch has it."""
        cfg = self.cfg
        slope = cfg.lrelu_slope
        conv = Conv3x3.nhwc if self.impl == "pallas" else Conv3x3.lax_nhwc
        fea = conv(self.conv_first, x)
        fea = fea + conv(self.conv_body, self.body(fea))
        for u in range(1, cfg.n_upsample + 1):
            up = getattr(self, f"conv_up{u}")
            if self._polyphase:     # channels-last out: contiguous NHWC
                fea = F.leaky_relu(up.up(fea.permute(0, 3, 1, 2))
                                   .permute(0, 2, 3, 1), slope)
            elif cfg.upsampler == "nearest_conv":
                fea = F.leaky_relu(conv(up, nearest_upsample_nhwc(fea)),
                                   slope)
            else:
                fea = pixel_shuffle_nhwc(F.leaky_relu(conv(up, fea), slope),
                                         2)
        fea = F.leaky_relu(conv(self.conv_hr, fea), slope)
        return conv(self.conv_last, fea)
