"""ESRGAN dense block: the hand-written Hopper kernel and its plain
PyTorch version.

:func:`dense_block` computes, on an NCHW input x of C channels with
growth G, for k = 1..4 ``x_k = LReLU(conv3x3(cat(x, x_1..x_{k-1})) +
b_k)`` and returns ``y = x + res_scale * conv5(cat(x, x_1..x_4))``.  It
replaces the TPU kernels ``ops/pallas/dense_block_cf.py:
fused_dense_block_cf5`` and ``ops/pallas/dense_block_cf_ext.py:
fused_dense_block_cf9`` of the JAX package and keeps their numerics:
f32 accumulation, f32 bias, each conv output rounded to x's dtype
(conv5 before the f32 residual), y rounded to x's dtype.

On a CUDA tensor it launches the kernel of ``csrc/dense_block.cu`` five
times (one per conv) or raises; on a CPU tensor it runs
:func:`dense_block_plain`, five ``F.conv2d`` in f32 with the same
rounding points.  The kernel has no width or band constraint, so it
serves every geometry either TPU kernel served, and also the heights
the JAX package sent to lax (H not divisible by 8).

Bound at the flagship shape (8, 64, 128, 128) bf16: 62.8 GFLOP per
block, about 63.5 us at 989 TFLOP/s, against about 10 us to move its
34.0 MB at 3.35 TB/s — bound by operations.  The bf16 path runs every
multiply-add on the tensor cores; the source note in
``csrc/dense_block.cu`` describes the design and PERF.md its times.
The kernel works on a channels-last copy of x (one feature buffer per
call), so a tile's channels move as 16-byte pieces.

Weights are packed once per model (:func:`pack_weight`), when
parameters are loaded or cast, as (9, cout, cin) in the compute dtype;
biases stay f32.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.device import no_tf32

N_CONVS = 5
LAUNCHES_PER_BLOCK = N_CONVS   # one kernel launch per conv
MAX_WIDTH = 64                 # widest growth / filters the kernel takes


def pack_weight(w_oihw: torch.Tensor) -> torch.Tensor:
    """(cout, cin, 3, 3) OIHW -> (9, cout, cin), tap = dy*3 + dx."""
    cout, cin, kh, kw = w_oihw.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {tuple(w_oihw.shape)}")
    return w_oihw.permute(2, 3, 0, 1).reshape(9, cout, cin).contiguous()


def unpack_weight(w_packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_weight`: (9, cout, cin) -> OIHW."""
    _, cout, cin = w_packed.shape
    return w_packed.reshape(3, 3, cout, cin).permute(2, 3, 0, 1)


def _check(x: torch.Tensor, weights: Sequence[torch.Tensor],
           biases: Sequence[torch.Tensor]) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NCHW)")
    if len(weights) != N_CONVS or len(biases) != N_CONVS:
        raise ValueError(f"expected {N_CONVS} weights and biases, got "
                         f"{len(weights)} and {len(biases)}")
    if any(wk.dim() != 3 for wk in weights):
        raise ValueError("weights must be packed (9, cout, cin) "
                         "(ops.dense_block.pack_weight)")
    c = x.shape[1]
    growth = weights[0].shape[1]
    widths = (c, growth)
    if any(v % 8 or v > MAX_WIDTH for v in widths) or min(widths) < 8:
        raise ValueError(
            f"dense-block kernel takes channels and growth that are "
            f"multiples of 8 in [8, {MAX_WIDTH}], got channels={c}, "
            f"growth={growth}")
    cin = c
    for k, (wk, bk) in enumerate(zip(weights, biases)):
        cout = c if k == N_CONVS - 1 else growth
        if tuple(wk.shape) != (9, cout, cin):
            raise ValueError(f"conv{k + 1} weight must be packed "
                             f"(9, {cout}, {cin}), got {tuple(wk.shape)}")
        if tuple(bk.shape) != (cout,):
            raise ValueError(f"conv{k + 1} bias must be ({cout},), got "
                             f"{tuple(bk.shape)}")
        if wk.dtype != x.dtype or bk.dtype != torch.float32:
            raise TypeError(f"conv{k + 1}: weight must be {x.dtype} and "
                            f"bias float32, got {wk.dtype}, {bk.dtype}")
        if wk.device != x.device or bk.device != x.device:
            raise ValueError(f"conv{k + 1}: weights on {wk.device}, "
                             f"bias on {bk.device}, x on {x.device}")
        if not (wk.is_contiguous() and bk.is_contiguous()):
            raise ValueError(f"conv{k + 1}: weight and bias must be "
                             f"contiguous")
        if wk.is_cuda and wk.data_ptr() % 16:
            raise ValueError(f"conv{k + 1}: weight must be 16-byte aligned "
                             f"(the kernel copies 16-byte pieces)")
        cin += growth


def dense_block_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor], *, res_scale: float,
                      slope: float) -> torch.Tensor:
    """The plain PyTorch version of the kernel: five ``F.conv2d`` in f32
    (no TF32) with the kernel's rounding points.  Takes the kernel's
    packed weights."""
    dtype = x.dtype
    feats = [x.float()]
    with no_tf32():
        for k, (wk, bk) in enumerate(zip(weights, biases)):
            o = F.conv2d(torch.cat(feats, 1), unpack_weight(wk).float(),
                         bk.float(), padding=1)
            if k < N_CONVS - 1:
                feats.append(F.leaky_relu(o, slope).to(dtype).float())
    return (feats[0] + res_scale * o.to(dtype).float()).to(dtype)


def _lib() -> ctypes.CDLL:
    from super_resolution_tpu_torch.build import load

    lib = load("dense_block")
    if lib.dense_block_conv.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dense_block_conv.argtypes = [
            i, vp, i, i, vp, vp, i, vp, vp, i, i, i, f, f, i, vp]
        lib.dense_block_conv.restype = ctypes.c_int
        lib.dense_block_error_string.argtypes = [i]
        lib.dense_block_error_string.restype = ctypes.c_char_p
    return lib


def dense_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor], *, res_scale: float,
                slope: float) -> torch.Tensor:
    """One dense block on NCHW ``x`` (float32 or bfloat16) with packed
    weights.  CUDA tensors launch the kernel (and count the launches in
    ``dense_block.launches``); CPU tensors take the plain version."""
    _check(x, weights, biases)
    if x.device.type == "cpu":
        return dense_block_plain(x, weights, biases, res_scale=res_scale,
                                 slope=slope)
    if x.device.type != "cuda":
        raise ValueError(f"dense_block runs on cuda or cpu, not {x.device}")
    lib = _lib()
    b, c, h, w = x.shape
    growth = weights[0].shape[1]
    c_total = c + (N_CONVS - 1) * growth
    with torch.cuda.device(x.device):
        # channels-last feature buffer: x, then each conv's output slice
        buf = torch.empty((b, h, w, c_total), dtype=x.dtype, device=x.device)
        buf[..., :c].copy_(x.permute(0, 2, 3, 1))
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        cin = c
        for k in range(N_CONVS):
            last = k == N_CONVS - 1
            cout = weights[k].shape[1]
            out = y.data_ptr() if last else \
                buf.data_ptr() + cin * buf.element_size()
            rc = lib.dense_block_conv(
                int(x.dtype == torch.bfloat16), buf.data_ptr(), c_total,
                cin, weights[k].data_ptr(), biases[k].data_ptr(), cout, out,
                x.data_ptr(), b, h, w, float(slope), float(res_scale),
                int(last), stream)
            if rc != 0:
                msg = lib.dense_block_error_string(rc).decode()
                raise RuntimeError(f"dense_block conv{k + 1}: kernel launch "
                                   f"failed with CUDA error {rc} ({msg})")
            dense_block.launches += 1
            cin += cout
    return y


dense_block.launches = 0
