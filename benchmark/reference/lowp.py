"""The control: the reference's convolutions one precision step below
the configuration's bfloat16, in 8-bit floating point.

Each conv's input and weight are rounded to float8 e4m3 with one scale
per tensor (its largest magnitude maps to e4m3's 448), the products
summed in float32 and the bias added in float32, as an fp8 conv with a
float32 accumulator computes them.  In the backward the cotangent is
rounded to float8 e5m2 the same way (largest magnitude to 57344), and
the data and weight gradients are taken against the rounded input and
weight.
"""

from __future__ import annotations

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn,
              top: float = E4M3_MAX) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).float() * scale


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride):
        qx, qw = round_fp8(x), round_fp8(w)
        ctx.save_for_backward(qx, qw)
        ctx.stride = stride
        return torch.nn.functional.conv2d(qx, qw, b, stride=stride,
                                          padding=1)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = round_fp8(g, torch.float8_e5m2, E5M2_MAX)
        dx, dw, db = torch.ops.aten.convolution_backward(
            qg, qx, qw, [qw.shape[0]], [ctx.stride] * 2, [1, 1], [1, 1],
            False, [0, 0], 1, list(ctx.needs_input_grad[:3]))
        return dx, dw, db, None


def conv_fp8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             stride: int = 1) -> torch.Tensor:
    return _Fp8Conv.apply(x, w, b, stride)
