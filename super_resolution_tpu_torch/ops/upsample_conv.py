"""Nearest-×2 upsample + 3×3 SAME conv as four 2×2 convs on the small
plane (the JAX package's ``ops/upsample_conv.py``).

Nearest upsampling repeats each pixel 2×2, so the composite is exactly
one 2×2 conv per output phase (a, b) ∈ {0, 1}²:

    out[2y+a, 2x+b] = Σ_{dy,dx} W[dy+1, dx+1] · x[y + ⌊(a+dy)/2⌋,
                                                  x + ⌊(b+dx)/2⌋]

Per phase the three kernel rows collapse to two: a = 0 takes rows
(y-1: W0, y: W1+W2), a = 1 takes (y: W0+W1, y+1: W2), and the columns
of each the same way.  4 phases × 4 taps = 16 MAC-taps per source pixel
against the naive form's 36, and the 4×-size plane is never read.  The
parameter stays the ordinary 3×3 weight (OIHW here), so checkpoints,
``.pth`` import/export and ``net_interp`` do not change.

The JAX function runs one conv per phase, each with its own padding.
Here the four 2×2 kernels are stacked along the output channels and run
as one conv with padding 1 on the small plane, in channels-last storage
(cuDNN's fast layout for it on the card): its output pixel (i, j) reads
rows i-1, i and columns j-1, j, so phase (a, c) of output pixel (y, x)
is at (y+a, x+c), channels (2a+c)·F onwards.  That address is linear in
(y, a, x, c, f), so the interleave is one strided view of the conv's
output, read once by the bias add that writes the result.

This is no kernel of the port: the JAX function is
``lax.conv_general_dilated`` outside any Pallas kernel, and its
counterpart here is ``F.conv2d`` (cuDNN on the card).  The arithmetic
keeps the JAX rounding points: the 3×3 kernel is cast to the compute
dtype first, then the row sums are formed, then the column sums of
those, in the JAX order; the bias is added in the compute dtype after
the phases are interleaved.  The convs run with TF32 off (the JAX
package pins ``Precision.HIGHEST`` for float32).

The NCHW result is in ``torch.channels_last`` memory format, the layout
of the ``pallas_cf_tail`` tail.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.device import no_tf32

PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))     # (row, column) offsets


def phase_kernels(w: torch.Tensor) -> torch.Tensor:
    """The (4F, C, 2, 2) stack of the phases' kernels, (a, b) in the order
    of :data:`PHASES`, from the (F, C, 3, 3) kernel ``w`` already in the
    compute dtype: row sums first, then column sums."""
    def row_taps(a):
        if a == 0:
            return w[:, :, 0:1], w[:, :, 1:2] + w[:, :, 2:3]
        return w[:, :, 0:1] + w[:, :, 1:2], w[:, :, 2:3]

    out = []
    for a in (0, 1):
        r_prev, r_cur = row_taps(a)
        for b in (0, 1):
            if b == 0:
                k2 = torch.cat([
                    torch.cat([r_prev[..., 0:1],
                               r_prev[..., 1:2] + r_prev[..., 2:3]], 3),
                    torch.cat([r_cur[..., 0:1],
                               r_cur[..., 1:2] + r_cur[..., 2:3]], 3),
                ], 2)
            else:
                k2 = torch.cat([
                    torch.cat([r_prev[..., 0:1] + r_prev[..., 1:2],
                               r_prev[..., 2:3]], 3),
                    torch.cat([r_cur[..., 0:1] + r_cur[..., 1:2],
                               r_cur[..., 2:3]], 3),
                ], 2)
            out.append(k2)
    return torch.cat(out)


def nearest_up_conv_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         kernels: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(B, C, H, W) → (B, F, 2H, 2W): nearest-×2 upsample, 3×3 SAME conv
    with the (F, C, 3, 3) ``w`` and bias ``b``, in x's dtype.
    ``kernels`` is :func:`phase_kernels` of ``w`` cast to x's dtype,
    when already formed (the cached inference path)."""
    if kernels is None:
        kernels = phase_kernels(w.to(x.dtype))
    bsz, _, h, wd = x.shape
    f = kernels.shape[0] // 4
    with no_tf32():
        o = F.conv2d(x.contiguous(memory_format=torch.channels_last),
                     kernels, padding=1)                 # (B, 4F, H+1, W+1)
    o = o.contiguous(memory_format=torch.channels_last)
    sb, sc, sh, sw = o.stride()
    # (b, y, a, x, c, f) -> o[b, (2a+c)F + f, y+a, x+c]
    src = o.as_strided((bsz, h, 2, wd, 2, f),
                       (sb, sh, sh + 2 * f * sc, sw, sw + f * sc, sc))
    bias = b.to(x.dtype)
    if torch.is_grad_enabled() and (src.requires_grad or bias.requires_grad):
        y = (src + bias).reshape(bsz, 2 * h, 2 * wd, f)
    else:
        y = x.new_empty((bsz, 2 * h, 2 * wd, f))
        torch.add(src, bias, out=y.view(bsz, h, 2, wd, 2, f))
    return y.permute(0, 3, 1, 2)


def nearest_up_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    kernels: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(B, H, W, C) → (B, 2H, 2W, F), contiguous: the NHWC entry, on the
    channels-last view of x."""
    y = nearest_up_conv_nchw(x.permute(0, 3, 1, 2), w, b, kernels)
    return y.permute(0, 2, 3, 1).contiguous()
