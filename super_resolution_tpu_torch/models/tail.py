"""The ×2^n upsampling tail that RRDBNet and SwinIR share: per ×2 stage
an upsample and a 3×3 conv with LeakyReLU (``conv_up{u}``), then
``conv_hr`` with LeakyReLU and ``conv_last``, on an NCHW feature map.

With ``kernel`` the upsample convs and ``conv_hr`` run the single-conv
kernel (:meth:`models.rrdb.Conv3x3.cf`, LeakyReLU fused) on the map's
``torch.channels_last`` storage, and ``conv_last`` is ``F.conv2d`` on
it; without, every conv is ``F.conv2d`` and LeakyReLU a separate op in
the compute dtype.  ``polyphase`` runs each nearest ×2 + conv as four
2×2 convs on the small plane (:meth:`Conv3x3.up`) under either.  The
upsample is nearest (``nearest_conv``) or the conv then a pixel shuffle
(``pixelshuffle``)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.ops.shuffle import (
    nearest_upsample,
    nearest_upsample_nhwc,
    pixel_shuffle,
    pixel_shuffle_nhwc,
)


def on_nhwc(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of an NHWC op on the channels-last storage of NCHW ``x``;
    the result is NCHW in channels-last memory format again."""
    return fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def upsample_tail(fea: torch.Tensor, ups: Sequence, conv_hr, conv_last, *,
                  slope: float, kernel: bool, polyphase: bool = False,
                  upsampler: str = "nearest_conv") -> torch.Tensor:
    """``conv_last(lrelu(conv_hr(up(... up(fea)))))`` with ``ups`` the
    ``conv_up{u}`` convs in order (:class:`models.rrdb.Conv3x3`)."""
    for conv in ups:
        if polyphase:
            fea = F.leaky_relu(conv.up(fea), slope)
        elif kernel and upsampler == "nearest_conv":
            fea = conv.cf(on_nhwc(nearest_upsample_nhwc, fea), True, slope)
        elif kernel:
            fea = on_nhwc(lambda t: pixel_shuffle_nhwc(t, 2),
                          conv.cf(fea, True, slope))
        elif upsampler == "nearest_conv":
            fea = F.leaky_relu(conv(nearest_upsample(fea, 2)), slope)
        else:
            fea = pixel_shuffle(F.leaky_relu(conv(fea), slope), 2)
    if kernel:
        return conv_last(conv_hr.cf(fea, True, slope))
    return conv_last(F.leaky_relu(conv_hr(fea), slope))
