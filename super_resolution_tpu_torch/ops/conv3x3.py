"""One 3×3 SAME conv: the hand-written Hopper kernel and its plain PyTorch
version.

The JAX package computes this function in two TPU kernels, one per
layout: ``ops/pallas/conv_cf.py:conv3x3_cf_fwd`` on (B, C, H, W), the
tail convs of ``conv_impl="pallas_cf_tail"``, and
``ops/pallas/packed_conv.py:packed_conv3x3`` on (B, H, W, C), every
conv of ``conv_impl="pallas"``.  Both are ``y = conv3x3(x) + b`` with an
optional LeakyReLU: f32 accumulation, the f32 bias added in f32, the
activation in f32, one rounding to the output dtype.  Here one kernel,
``csrc/conv3x3.cu``, serves both:

- :func:`conv3x3` reads a channels-last (B, H, W, C) tensor, or a
  channel prefix of a wider channels-last buffer, and can write into a
  channel slice of another (``out=``): the kernel takes a pixel stride
  for each, so a dense block's concat costs nothing.
  :func:`packed_conv3x3` is the same call with the JAX function's
  argument names.
- :func:`conv3x3_cf` takes and returns (B, C, H, W).  The kernel reads
  and writes the tensor's ``torch.channels_last`` storage, so the model
  keeps its tail in that memory format; a contiguous NCHW argument is
  converted once here and counted in ``conv3x3_cf.conversions``.
- :func:`conv3x3_cf_train` is :func:`conv3x3_cf` with a gradient: the
  JAX custom VJP's backward, which is lax's VJP of the reference conv
  (bias added in x's dtype, the cotangent cast to x's dtype, the
  LeakyReLU gradient 1 where y >= 0).  The JAX package runs that
  backward outside any Pallas kernel, so here it is PyTorch's
  convolution backward (cuDNN on the card, TF32 off in float32).

Weights are packed (9, cout, cin) in x's dtype
(``ops.dense_block.pack_weight``), biases are float32.  A bfloat16 input
whose channels are not a multiple of 8 (``conv_first``: 3) is padded
with zero channels, input and weights, before the launch: the kernel
copies 16-byte pieces; the zeros add nothing to any sum.  That costs one
small copy of the input (8 channels a pixel) per call.

On a CUDA tensor each function launches the kernel (counted in
``conv3x3.launches``) or raises; on a CPU tensor it runs
:func:`conv3x3_plain`, an f32 ``F.conv2d`` (TF32 off) with the kernel's
rounding point.  The kernel takes every H and W: the JAX package sends
a plane its band picker rejects to lax, the port does not.

Bound of the flagship tail conv, a (8, 512, 512) plane of 64 -> 64
channels in bf16: 154.6 GFLOP, 0.156 ms at 989 TFLOP/s, against 537 MB
in and out, 0.160 ms at 3.35 TB/s: operations and bytes alike; the
source note in ``csrc/conv3x3.cu`` says what the design does about it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from super_resolution_tpu_torch.device import no_tf32
from super_resolution_tpu_torch.ops.dense_block import (
    pack_weight,
    unpack_weight,
)

BF16_CHANNELS = 8          # bf16 input channels come in 16-byte pieces


def _pixel_stride(t: torch.Tensor, what: str) -> int:
    """Channels per pixel of the channels-last buffer that ``t`` (B, H, W,
    C) views: ``t`` must be the buffer or a channel slice of it."""
    if t.dim() != 4:
        raise ValueError(f"{what} must be (B, H, W, C), got "
                         f"{tuple(t.shape)}")
    b, h, w, c = t.shape
    s = t.stride(2)
    if not ((t.stride(3) == 1 or c == 1) and s >= c
            and (h == 1 or t.stride(1) == w * s)
            and (b == 1 or t.stride(0) == h * w * s)):
        raise ValueError(f"{what} must be channels-last: a contiguous "
                         f"(B, H, W, C) tensor or a channel slice of one, "
                         f"got strides {t.stride()}")
    return s


def _check(x, w, b, out_dtype, out) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {x.dtype} or float32, got "
                        f"{out_dtype}")
    cin = x.shape[-1]
    if w.dim() != 3 or w.shape[0] != 9 or w.shape[2] != cin:
        raise ValueError(f"the weight must be packed (9, cout, {cin}) "
                         f"(ops.dense_block.pack_weight), got "
                         f"{tuple(w.shape)}")
    if w.dtype != x.dtype or not w.is_contiguous():
        raise TypeError(f"the weight must be a contiguous {x.dtype} "
                        f"tensor, got {w.dtype}")
    if tuple(b.shape) != (w.shape[1],) or b.dtype != torch.float32 \
            or not b.is_contiguous():
        raise ValueError(f"the bias must be a contiguous float32 "
                         f"({w.shape[1]},) tensor, got {b.dtype} "
                         f"{tuple(b.shape)}")
    for t, name in ((w, "weight"), (b, "bias")):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if out is not None:
        want = (*x.shape[:3], w.shape[1])
        if tuple(out.shape) != want or out.dtype != out_dtype or \
                out.device != x.device:
            raise ValueError(f"out must be a {out_dtype} {want} tensor on "
                             f"{x.device}, got {out.dtype} "
                             f"{tuple(out.shape)} on {out.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, b)):
        raise RuntimeError(
            "conv3x3 has no gradient here, and an input requires one: use "
            "conv3x3_cf_train (RRDBNet.prepare(dtype, live=True) under "
            "conv_impl pallas_cf_tail), or run under torch.no_grad()")


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  act: bool, slope: float,
                  out_dtype: Optional[torch.dtype] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel behind :func:`conv3x3`'s
    interface: NHWC in, NHWC out (into ``out`` when given, else a new
    contiguous tensor); ``F.conv2d`` in f32 (no TF32) with the f32 bias,
    the LeakyReLU in f32 and one rounding to ``out_dtype`` (x's dtype
    when None).  What :func:`conv3x3` runs on a CPU tensor; a check can
    put it in :func:`conv3x3`'s place to drive a model through the plain
    version on any device."""
    with no_tf32():
        y = F.conv2d(x.permute(0, 3, 1, 2).float(), unpack_weight(w).float(),
                     b.float(), padding=1)
    if act:
        y = F.leaky_relu(y, slope)
    y = y.to(out_dtype or x.dtype).permute(0, 2, 3, 1)
    return y.contiguous() if out is None else out.copy_(y)


def _lib() -> ctypes.CDLL:
    from super_resolution_tpu_torch.build import load

    lib = load("conv3x3")
    if lib.conv3x3_launch.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.conv3x3_launch.argtypes = [i, i, vp, i, i, vp, vp, i, vp, i, i,
                                       f, i, i, i, vp]
        lib.conv3x3_launch.restype = ctypes.c_int
        lib.conv3x3_error_string.argtypes = [i]
        lib.conv3x3_error_string.restype = ctypes.c_char_p
    return lib


def _pad_channels(x: torch.Tensor, w: torch.Tensor):
    """bf16 input channels padded with zeros to a multiple of 8, input
    (a new contiguous buffer) and weights alike."""
    cin = x.shape[-1]
    c8 = -(-cin // BF16_CHANNELS) * BF16_CHANNELS
    xp = x.new_zeros((*x.shape[:3], c8))
    xp[..., :cin].copy_(x)
    wp = w.new_zeros((9, w.shape[1], c8))
    wp[..., :cin].copy_(w)
    return xp, wp


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
            act: bool, slope: float,
            out_dtype: Optional[torch.dtype] = None,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME 3×3 conv of NHWC ``x`` with packed ``w`` (9, cout, cin) and
    f32 ``b``, LeakyReLU if ``act``, in ``out_dtype`` (x's dtype when
    None).  ``x`` may be a channel prefix of a wider channels-last
    buffer, ``out`` a channel slice of one, written in place and
    returned; else a new contiguous (B, H, W, cout) tensor.  CUDA
    tensors launch the kernel (``conv3x3.launches``), CPU tensors take
    :func:`conv3x3_plain`."""
    out_dtype = out_dtype or x.dtype
    _check(x, w, b, out_dtype, out)
    c_in = _pixel_stride(x, "x")
    c_out = 0 if out is None else _pixel_stride(out, "out")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, act=act, slope=slope,
                             out_dtype=out_dtype, out=out)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on cuda or cpu, not {x.device}")
    lib = _lib()
    is_bf16 = x.dtype == torch.bfloat16
    if is_bf16 and (x.shape[-1] % BF16_CHANNELS or c_in % BF16_CHANNELS
                    or x.data_ptr() % 16 or w.data_ptr() % 16):
        x, w = _pad_channels(x, w)
        c_in = x.shape[-1]
    bsz, h, wd, cin = x.shape
    cout = w.shape[1]
    with torch.cuda.device(x.device):
        if out is None:
            out = torch.empty((bsz, h, wd, cout), dtype=out_dtype,
                              device=x.device)
            c_out = cout
        rc = lib.conv3x3_launch(
            int(is_bf16), int(out_dtype == torch.bfloat16), x.data_ptr(),
            c_in, cin, w.data_ptr(), b.data_ptr(), cout, out.data_ptr(),
            c_out, int(act), float(slope), bsz, h, wd,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            msg = lib.conv3x3_error_string(rc).decode()
            raise RuntimeError(f"conv3x3: kernel launch failed with CUDA "
                               f"error {rc} ({msg})")
        conv3x3.launches += 1
    return out


conv3x3.launches = 0


def packed_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                   apply_act: bool = True, slope: float = 0.2,
                   out_dtype: Optional[torch.dtype] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`conv3x3` under the JAX ``packed_conv3x3``'s argument names
    (NHWC; ``out_dtype`` None means x's dtype)."""
    return conv3x3(x, w, b, act=apply_act, slope=slope, out_dtype=out_dtype,
                   out=out)


def conv3x3_cf(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               act: bool = False, slope: float = 0.2) -> torch.Tensor:
    """The conv on (B, C, H, W) ``x``, returning (B, F, H, W) in
    ``torch.channels_last`` memory format and x's dtype.  An argument
    not in that format is converted first (``conv3x3_cf.conversions``)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    x_nhwc = x.permute(0, 2, 3, 1)
    if not x_nhwc.is_contiguous():
        x_nhwc = x_nhwc.contiguous()
        conv3x3_cf.conversions += 1
    return conv3x3(x_nhwc, w, b, act=act, slope=slope).permute(0, 3, 1, 2)


conv3x3_cf.conversions = 0


class _Conv3x3CfTrain(torch.autograd.Function):
    """Forward: the kernel.  Backward: lax's VJP of the reference conv,
    as the JAX ``conv3x3_cf``'s custom VJP has it."""

    @staticmethod
    def forward(ctx, x, w, b, act, slope):
        y = conv3x3_cf(x, w, b, act=act, slope=slope)
        ctx.save_for_backward(x, w, y if act else None)
        ctx.act, ctx.slope = act, slope
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = g.to(x.dtype)
        if ctx.act:
            # y >= 0 exactly where the pre-activation is (slope > 0); at
            # 0 the identity branch, as jnp.where(y >= 0, ...) has it
            g = torch.where(y >= 0, g, g * ctx.slope)
        with no_tf32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, unpack_weight(w).contiguous(), None, [1, 1], [1, 1],
                [1, 1], False, [0, 0], 1, [True, True, False])
        # the bias was added in x's dtype: its gradient is that dtype's
        db = g.float().sum((0, 2, 3)).to(x.dtype).float()
        return dx, pack_weight(dw).to(w.dtype), db, None, None


def conv3x3_cf_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     act: bool, slope: float) -> torch.Tensor:
    """The differentiable :func:`conv3x3_cf`: dx in x's dtype, dW (packed)
    in w's dtype, db in float32."""
    return _Conv3x3CfTrain.apply(x, w, b, bool(act), float(slope))
