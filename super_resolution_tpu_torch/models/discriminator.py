"""VGG-style patch discriminator in PyTorch: NHWC in, NCHW inside.

The architecture of the JAX package's ``models/discriminator.py``: conv
widths 64, 64, 128, 128, 256, 256, 512, 512 alternating stride 1 / 2
(explicit padding 1 on every conv), BatchNorm on every conv except the
first, LeakyReLU 0.2, and a 1-channel 3x3 conv head that produces an
(H/16, W/16, 1) logit map.  4,693,697 parameters at default width.
Module names follow the flax tree (``conv{i}_{j}``, ``bn{i}_{j}``,
``head``).

:class:`BatchNorm` is written out, not ``nn.BatchNorm2d``: flax updates
the running variance with the *biased* batch variance (torch uses the
unbiased one), takes the statistics in float32 whatever the compute
dtype, as ``E[x^2] - E[x]^2`` clipped at 0, and its momentum 0.9 is
torch's 0.1.  ``update_stats=False`` normalises with the batch
statistics without touching the running ones — the generator step's
forwards, whose statistics the JAX step throws away.  The batch
statistics are the global batch's: under data parallelism the local
means of x and x² are averaged over the ranks with gradient
(:func:`parallel.dp.global_mean`), so every rank normalises alike and
its running statistics update alike.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from super_resolution_tpu_torch.config import DiscriminatorConfig
from super_resolution_tpu_torch.device import no_tf32
from super_resolution_tpu_torch.models.initializers import conv_init_
from super_resolution_tpu_torch.parallel import dp


class BatchNorm(nn.Module):
    """Batch norm over (B, H, W) of an NCHW tensor with flax's numerics
    (see the module docstring).  ``momentum`` is flax's: the share of
    the old running value that is kept."""

    def __init__(self, features: int, momentum: float, eps: float):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool,
                update_stats: bool = True) -> torch.Tensor:
        x32 = x.float()
        if train:
            mean, sq = x32.mean((0, 2, 3)), (x32 * x32).mean((0, 2, 3))
            if dp.active():     # one all-reduce for both
                mean, sq = dp.global_mean(torch.stack([mean, sq])).unbind()
            var = (sq - mean * mean).clamp_min(0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                    self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(x.dtype)


class Discriminator(nn.Module):
    """``forward`` takes NHWC images in normalised space and returns
    float32 logits (B, H/16, W/16, 1); with ``return_features`` also the
    per-scale post-activation feature maps (NHWC float32), the basis of
    the discriminator-feature-matching perceptual loss.  Weights are
    drawn from ``generator`` (seed 0 when None) with nn.Conv2d's default
    init, as the JAX package does."""

    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig(),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cin = cfg.channels
        for i in range(cfg.n_scales):
            feats = cfg.base_filters * 2 ** i
            for j, stride in enumerate((1, 2)):
                conv = nn.Conv2d(cin, feats, 3, stride, 1)
                conv_init_("torch_default", conv.weight, conv.bias, generator)
                setattr(self, f"conv{i}_{j}", conv)
                if (i, j) != (0, 0):
                    setattr(self, f"bn{i}_{j}", BatchNorm(
                        feats, cfg.bn_momentum, cfg.bn_eps))
                cin = feats
        self.head = nn.Conv2d(cin, 1, 3, 1, 1)
        conv_init_("torch_default", self.head.weight, self.head.bias,
                   generator)

    def _conv(self, name: str, h: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, name)
        return F.conv2d(h, conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), conv.stride, 1)

    def forward(self, x: torch.Tensor, train: bool = True,
                return_features: bool = False, update_stats: bool = True):
        slope = self.cfg.lrelu_slope
        features = []
        with no_tf32():
            h = x.permute(0, 3, 1, 2).to(self.dtype)
            for i in range(self.cfg.n_scales):
                for j in range(2):
                    h = self._conv(f"conv{i}_{j}", h)
                    if (i, j) != (0, 0):
                        h = getattr(self, f"bn{i}_{j}")(h, train,
                                                        update_stats)
                    h = F.leaky_relu(h, slope)
                features.append(h.float().permute(0, 2, 3, 1))
            logits = self._conv("head", h).float().permute(0, 2, 3, 1)
        if return_features:
            return logits, features
        return logits

    def batch_stats(self):
        """The running statistics, name -> tensor (views, not copies)."""
        return {k: v for k, v in self.named_buffers()}
