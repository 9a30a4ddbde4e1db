"""ESRGAN dense block: the hand-written Hopper kernels, forward and
backward, and their plain PyTorch versions.

:func:`dense_block` computes, on an NCHW input x of C channels with
growth G, for k = 1..4 ``x_k = LReLU(conv3x3(cat(x, x_1..x_{k-1})) +
b_k)`` and returns ``y = x + res_scale * conv5(cat(x, x_1..x_4))``.  It
replaces the TPU kernels ``ops/pallas/dense_block_cf.py:
fused_dense_block_cf5`` and ``ops/pallas/dense_block_cf_ext.py:
fused_dense_block_cf9`` of the JAX package and keeps their numerics:
f32 accumulation, f32 bias, each conv output rounded to x's dtype
(conv5 before the f32 residual), y rounded to x's dtype.  With
``save_acts=True`` it also returns the feature buffer
``cat(x, x_1..x_4)``, channels-last (B, H, W, C + 4G) — the buffer the
kernel works in, kept as it is for the backward.

:func:`dense_block_bwd` is the backward from that buffer, the weights
and the cotangent of y: dx in x's dtype, dW_k (9, cout, cin) and db_k
in f32.  It replaces ``ops/pallas/dense_block_cf_vjp.py:
fused_dense_block_cf5_bwd`` and keeps its rounding points (the
cotangent of every conv is rounded to x's dtype before the two products,
db is summed from the unrounded one) and its LeakyReLU gradient, which
takes the slope branch where a saved activation is exactly 0.
:func:`dense_block_train` is the differentiable block — a
``torch.autograd.Function`` over the two, named after the JAX
``dense_block_cf_train`` — and returns dW in the weights' dtype, as the
JAX VJP does.

:func:`fused_dense_block` is the same forward on an NHWC x, returning
an NHWC y: the NHWC entry of ``csrc/dense_block.cu``, which replaces
``ops/pallas/dense_block.py:fused_dense_block`` (the ``pallas_fused``
conv path).  x lands in the channels-last feature buffer as a strided
copy, and the last launch writes y channels-last.  The Pallas kernel
rounds each tap's partial product to the compute dtype before its f32
tap sum (a VMEM saving of the TPU); the port sums the taps in f32, so
bf16 results differ from it by that rounding, and float32 agrees.

On a CUDA tensor these launch the kernels of ``csrc/dense_block.cu``
(five launches, one per conv) and ``csrc/dense_block_bwd.cu`` (fifteen:
per conv a data gradient, a weight gradient and its reduction) or
raise; on a CPU tensor they run :func:`dense_block_plain` and
:func:`dense_block_bwd_plain`, PyTorch convolutions in f32 with the same
rounding points.  The kernels have no width or band constraint, so they
serve every geometry either TPU kernel served, and also the heights the
JAX package sent to lax (H not divisible by 8).

Bound of the forward at the flagship shape (8, 64, 128, 128) bf16:
62.8 GFLOP per block, about 63.5 us at 989 TFLOP/s, against about 10 us
to move its 34.0 MB at 3.35 TB/s — bound by operations; the backward is
twice the operations.  The bf16 paths run every multiply-add on the
tensor cores; the source notes in ``csrc/`` describe the designs and
PERF.md their times.

Weights are packed (:func:`pack_weight`) as (9, cout, cin) in the
compute dtype — once per model for inference, inside the graph each
forward for training; biases stay f32.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from super_resolution_tpu_torch.device import no_tf32

N_CONVS = 5
LAUNCHES_PER_BLOCK = N_CONVS       # forward: one kernel launch per conv
BWD_LAUNCHES_PER_BLOCK = 3 * N_CONVS   # dgrad, wgrad, reduce per conv
MAX_WIDTH = 64                 # widest growth / filters the kernels take
TILE = 16                      # the kernels' square pixel tile
WGRAD_BLOCKS = 264             # blocks a wgrad launch aims for (2 per SM)

Grads = Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]


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


def _check_weights(c: int, dtype: torch.dtype, device: torch.device,
                   weights: Sequence[torch.Tensor]) -> int:
    """Packed weights of a block of ``c`` channels; returns the growth."""
    if len(weights) != N_CONVS:
        raise ValueError(f"expected {N_CONVS} weights, got {len(weights)}")
    if any(wk.dim() != 3 for wk in weights):
        raise ValueError("weights must be packed (9, cout, cin) "
                         "(ops.dense_block.pack_weight)")
    growth = weights[0].shape[1]
    widths = (c, growth)
    if any(v % 8 or v > MAX_WIDTH for v in widths) or min(widths) < 8:
        raise ValueError(
            f"dense-block kernel takes channels and growth that are "
            f"multiples of 8 in [8, {MAX_WIDTH}], got channels={c}, "
            f"growth={growth}")
    cin = c
    for k, wk in enumerate(weights):
        cout = c if k == N_CONVS - 1 else growth
        if tuple(wk.shape) != (9, cout, cin):
            raise ValueError(f"conv{k + 1} weight must be packed "
                             f"(9, {cout}, {cin}), got {tuple(wk.shape)}")
        if wk.dtype != dtype:
            raise TypeError(f"conv{k + 1}: weight must be {dtype}, got "
                            f"{wk.dtype}")
        if wk.device != device:
            raise ValueError(f"conv{k + 1}: weights on {wk.device}, x on "
                             f"{device}")
        if not wk.is_contiguous():
            raise ValueError(f"conv{k + 1}: weight must be contiguous")
        if wk.is_cuda and wk.data_ptr() % 16:
            raise ValueError(f"conv{k + 1}: weight must be 16-byte aligned "
                             f"(the kernel copies 16-byte pieces)")
        cin += growth
    return growth


def _check(x: torch.Tensor, weights: Sequence[torch.Tensor],
           biases: Sequence[torch.Tensor], layout: str = "NCHW") -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be {layout}, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous ({layout})")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights, *biases)):
        raise RuntimeError(
            "the dense-block forward has no gradient here, and an input "
            "requires one: use dense_block_train (RRDBNet.prepare(dtype, "
            "live=True) under conv_impl pallas_cf or pallas_cf_tail), or "
            "run under torch.no_grad()")
    _check_weights(x.shape[layout.index("C")], x.dtype, x.device, weights)
    if len(biases) != N_CONVS:
        raise ValueError(f"expected {N_CONVS} biases, got {len(biases)}")
    for k, (wk, bk) in enumerate(zip(weights, biases)):
        if tuple(bk.shape) != (wk.shape[1],):
            raise ValueError(f"conv{k + 1} bias must be ({wk.shape[1]},), "
                             f"got {tuple(bk.shape)}")
        if bk.dtype != torch.float32:
            raise TypeError(f"conv{k + 1}: bias must be float32, got "
                            f"{bk.dtype}")
        if bk.device != x.device:
            raise ValueError(f"conv{k + 1}: bias on {bk.device}, x on "
                             f"{x.device}")
        if not bk.is_contiguous():
            raise ValueError(f"conv{k + 1}: bias must be contiguous")


def _check_bwd(feats: torch.Tensor, weights: Sequence[torch.Tensor],
               g: torch.Tensor) -> int:
    """The training entry's saved buffer and cotangent; returns C."""
    if feats.dim() != 4 or not feats.is_contiguous():
        raise ValueError(f"the saved feature buffer must be a contiguous "
                         f"(B, H, W, C + 4G) tensor, got "
                         f"{tuple(feats.shape)}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, got "
                        f"{feats.dtype}")
    if len(weights) != N_CONVS or weights[-1].dim() != 3:
        raise ValueError("weights must be five packed (9, cout, cin) "
                         "tensors")
    b, h, w, c_total = feats.shape
    c = weights[-1].shape[1]
    growth = _check_weights(c, feats.dtype, feats.device, weights)
    if c_total != c + (N_CONVS - 1) * growth:
        raise ValueError(f"feature buffer has {c_total} channels, the "
                         f"weights say {c} + 4 * {growth}")
    if tuple(g.shape) != (b, c, h, w):
        raise ValueError(f"the cotangent must be {(b, c, h, w)} like y, "
                         f"got {tuple(g.shape)}")
    if g.dtype != feats.dtype or g.device != feats.device:
        raise TypeError(f"the cotangent must be {feats.dtype} on "
                        f"{feats.device}, got {g.dtype} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("the cotangent must be contiguous (NCHW); "
                         "dense_block_train makes it so")
    return c


def feature_buffer(x: torch.Tensor,
                   acts: Sequence[torch.Tensor]) -> torch.Tensor:
    """NCHW x and x_1..x_4 -> the channels-last buffer the backward takes."""
    return torch.cat([x, *acts], 1).permute(0, 2, 3, 1).contiguous()


def split_features(feats: torch.Tensor, c: int, growth: int
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Inverse of :func:`feature_buffer`: (x, [x_1..x_4]), NCHW."""
    nchw = feats.permute(0, 3, 1, 2)
    return (nchw[:, :c].contiguous(),
            [nchw[:, c + k * growth:c + (k + 1) * growth].contiguous()
             for k in range(N_CONVS - 1)])


def dense_block_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor], *, res_scale: float,
                      slope: float, save_acts: bool = False):
    """The plain PyTorch version of the forward kernel: five ``F.conv2d``
    in f32 (no TF32) with the kernel's rounding points.  Takes the
    kernel's packed weights.  ``save_acts=True`` returns
    ``(y, [x_1..x_4])`` like the JAX kernel."""
    dtype = x.dtype
    feats = [x.float()]
    with no_tf32():
        for k, (wk, bk) in enumerate(zip(weights, biases)):
            o = F.conv2d(torch.cat(feats, 1), unpack_weight(wk).float(),
                         bk.float(), padding=1)
            if k < N_CONVS - 1:
                feats.append(F.leaky_relu(o, slope).to(dtype).float())
    y = (feats[0] + res_scale * o.to(dtype).float()).to(dtype)
    if save_acts:
        return y, [a.to(dtype) for a in feats[1:]]
    return y


def dense_block_bwd_plain(x: torch.Tensor, acts: Sequence[torch.Tensor],
                          weights: Sequence[torch.Tensor], g: torch.Tensor,
                          *, res_scale: float, slope: float) -> Grads:
    """The plain PyTorch version of the backward kernels, step by step as
    the JAX kernel's ``_win`` does it: ``(dx, [dW_k packed f32],
    [db_k f32])`` from NCHW x, the saved x_1..x_4, the packed weights and
    the cotangent g of y.  f32 (no TF32) throughout; dout_k is rounded
    to x's dtype before the two products, db_k is summed before."""
    dtype = x.dtype
    c = x.shape[1]
    growth = weights[0].shape[1]
    feats = torch.cat([x, *acts], 1).float()
    dfeats = torch.zeros_like(feats)
    dfeats[:, :c] = g.float()              # the residual's identity
    dws = [None] * N_CONVS
    dbs = [None] * N_CONVS
    with no_tf32():
        for k in range(N_CONVS - 1, -1, -1):
            c_k = c + k * growth
            if k == N_CONVS - 1:
                dout = g.float() * res_scale
            else:
                a = feats[:, c_k:c_k + growth]
                # at exactly 0 the slope branch, unlike autograd's
                # leaky_relu
                leak = torch.where(a > 0, 1.0, slope)
                dout = dfeats[:, c_k:c_k + growth] * leak
            dbs[k] = dout.sum((0, 2, 3))
            dz = dout.to(dtype).float()
            w_oihw = unpack_weight(weights[k]).float()
            dws[k] = pack_weight(torch.nn.grad.conv2d_weight(
                feats[:, :c_k], w_oihw.shape, dz, padding=1))
            dfeats[:, :c_k] += F.conv_transpose2d(dz, w_oihw, padding=1)
    return dfeats[:, :c].to(dtype), dws, dbs


def plain_forward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor], *, res_scale: float,
                  slope: float, save_acts: bool = False):
    """:func:`dense_block_plain` behind :func:`dense_block`'s interface:
    with ``save_acts`` the activations come back as the feature buffer.
    What :func:`dense_block` runs on a CPU tensor; a check can put it in
    :func:`dense_block`'s place to drive a model through the plain
    version on any device."""
    out = dense_block_plain(x, weights, biases, res_scale=res_scale,
                            slope=slope, save_acts=save_acts)
    return (out[0], feature_buffer(x, out[1])) if save_acts else out


def plain_backward(feats: torch.Tensor, weights: Sequence[torch.Tensor],
                   g: torch.Tensor, *, res_scale: float,
                   slope: float) -> Grads:
    """:func:`dense_block_bwd_plain` behind :func:`dense_block_bwd`'s
    interface (the saved feature buffer in place of x and x_1..x_4)."""
    x, acts = split_features(feats, weights[-1].shape[1],
                             weights[0].shape[1])
    return dense_block_bwd_plain(x, acts, weights, g, res_scale=res_scale,
                                 slope=slope)


def _argtypes(fn, types) -> None:
    fn.argtypes = types
    fn.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    from super_resolution_tpu_torch.build import load

    lib = load("dense_block")
    if lib.dense_block_conv.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _argtypes(lib.dense_block_conv,
                  [i, vp, i, i, vp, vp, i, vp, vp, i, i, i, f, f, i, i, vp])
        lib.dense_block_error_string.argtypes = [i]
        lib.dense_block_error_string.restype = ctypes.c_char_p
    return lib


def _lib_bwd() -> ctypes.CDLL:
    from super_resolution_tpu_torch.build import load

    lib = load("dense_block_bwd")
    if lib.dense_block_dgrad.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _argtypes(lib.dense_block_dgrad,
                  [i, vp, i, vp, i, vp, vp, i, vp, i, i, i, i, f, vp])
        _argtypes(lib.dense_block_wgrad,
                  [i, vp, vp, i, vp, i, i, i, vp, i, i, i, i, vp])
        _argtypes(lib.dense_block_wgrad_reduce, [vp, i, i, i, vp, vp, vp])
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().dense_block_error_string(rc).decode()
        raise RuntimeError(f"dense_block {what}: kernel launch failed with "
                           f"CUDA error {rc} ({msg})")


def _launch_block(counter, x: torch.Tensor, x_nhwc: torch.Tensor,
                  weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor], res_scale: float,
                  slope: float, nhwc: bool):
    """The five launches of one block on the card, each counted in
    ``counter.launches``: (y in x's layout, feature buffer)."""
    lib = _lib()
    b, h, w, c = x_nhwc.shape
    growth = weights[0].shape[1]
    c_total = c + (N_CONVS - 1) * growth
    with torch.cuda.device(x.device):
        # channels-last feature buffer: x, then each conv's output slice
        buf = torch.empty((b, h, w, c_total), dtype=x.dtype, device=x.device)
        buf[..., :c].copy_(x_nhwc)
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
                int(last), int(nhwc), stream)
            _raise_on(rc, f"conv{k + 1}")
            counter.launches += 1
            cin += cout
    return y, buf


def dense_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor], *, res_scale: float,
                slope: float, save_acts: bool = False):
    """One dense block on NCHW ``x`` (float32 or bfloat16) with packed
    weights.  CUDA tensors launch the kernel (and count the launches in
    ``dense_block.launches``); CPU tensors take the plain version.
    ``save_acts=True`` returns ``(y, feature buffer)``."""
    _check(x, weights, biases)
    if x.device.type == "cpu":
        return plain_forward(x, weights, biases, res_scale=res_scale,
                             slope=slope, save_acts=save_acts)
    if x.device.type != "cuda":
        raise ValueError(f"dense_block runs on cuda or cpu, not {x.device}")
    y, buf = _launch_block(dense_block, x, x.permute(0, 2, 3, 1), weights,
                           biases, res_scale, slope, nhwc=False)
    return (y, buf) if save_acts else y


dense_block.launches = 0


def fused_dense_block_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                            biases: Sequence[torch.Tensor], *,
                            res_scale: float, slope: float) -> torch.Tensor:
    """The plain version of :func:`fused_dense_block`: NHWC in and out,
    :func:`dense_block_plain` in between (the same rounding points)."""
    y = dense_block_plain(x.permute(0, 3, 1, 2).contiguous(), weights,
                          biases, res_scale=res_scale, slope=slope)
    return y.permute(0, 2, 3, 1).contiguous()


def fused_dense_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor], *, res_scale: float,
                      slope: float) -> torch.Tensor:
    """One dense block on NHWC ``x`` with packed weights, y NHWC: the
    NHWC entry of the forward kernel (counted in
    ``fused_dense_block.launches``) on CUDA tensors, its plain version
    on CPU tensors.  Every H and W, forward only."""
    _check(x, weights, biases, "NHWC")
    if x.device.type == "cpu":
        return fused_dense_block_plain(x, weights, biases,
                                       res_scale=res_scale, slope=slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense_block runs on cuda or cpu, not "
                         f"{x.device}")
    y, _ = _launch_block(fused_dense_block, x, x, weights, biases,
                         res_scale, slope, nhwc=True)
    return y


fused_dense_block.launches = 0


def wgrad_parts(n_pixels_tiles: int, cin: int, is_bf16: bool) -> int:
    """Workspace slots (pixel-tile ranges) of one wgrad launch: enough
    blocks to fill the card, a function of the shapes alone, so the
    reduction order and the result repeat bit for bit."""
    chunks = -(-cin // (32 if is_bf16 else 16))
    return min(n_pixels_tiles, max(1, -(-WGRAD_BLOCKS // chunks)))


def dense_block_bwd(feats: torch.Tensor, weights: Sequence[torch.Tensor],
                    g: torch.Tensor, *, res_scale: float,
                    slope: float) -> Grads:
    """Backward of one dense block from the forward's saved feature
    buffer (``dense_block(..., save_acts=True)``), the packed weights
    and the NCHW cotangent ``g`` of y: ``(dx, [dW_k (9, cout, cin) f32],
    [db_k f32])``.  CUDA tensors launch the backward kernels (counted in
    ``dense_block_bwd.launches``) or raise; CPU tensors take
    :func:`dense_block_bwd_plain`."""
    c = _check_bwd(feats, weights, g)
    growth = weights[0].shape[1]
    if feats.device.type == "cpu":
        return plain_backward(feats, weights, g, res_scale=res_scale,
                              slope=slope)
    if feats.device.type != "cuda":
        raise ValueError(f"dense_block_bwd runs on cuda or cpu, not "
                         f"{feats.device}")
    lib = _lib_bwd()
    b, h, w, c_total = feats.shape
    dtype, dev = feats.dtype, feats.device
    is_bf16 = int(dtype == torch.bfloat16)
    n_tiles = b * (-(-h // TILE)) * (-(-w // TILE))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        g_last = g.permute(0, 2, 3, 1)                 # (B, H, W, C) view
        dfeats = torch.zeros((b, h, w, c_total), dtype=torch.float32,
                             device=dev)
        dfeats[..., :c].copy_(g_last)                  # residual identity
        # conv5's cotangent, f32 and rounded, channels-last
        dout = (g_last.float() * res_scale).contiguous()
        dz = dout.to(dtype)
        dout_ptr, dout_stride = dout.data_ptr(), c
        # dz of convs 4..1, written by the dgrad epilogue of the conv above
        dz_act = [torch.empty((b, h, w, growth), dtype=dtype, device=dev)
                  for _ in range(2)]
        dws, dbs = [None] * N_CONVS, [None] * N_CONVS
        for k in range(N_CONVS - 1, -1, -1):
            c_k = c + k * growth
            cout = weights[k].shape[1]
            n_w = 9 * cout * c_k
            parts = wgrad_parts(n_tiles, c_k, bool(is_bf16))
            work = torch.empty((parts, n_w + cout), dtype=torch.float32,
                               device=dev)
            _raise_on(lib.dense_block_wgrad(
                is_bf16, dz.data_ptr(), dout_ptr, dout_stride,
                feats.data_ptr(), c_total, c_k, cout, work.data_ptr(),
                parts, b, h, w, stream), f"wgrad{k + 1}")
            dense_block_bwd.launches += 1
            dws[k] = torch.empty((9, cout, c_k), dtype=torch.float32,
                                 device=dev)
            dbs[k] = torch.empty((cout,), dtype=torch.float32, device=dev)
            _raise_on(lib.dense_block_wgrad_reduce(
                work.data_ptr(), parts, n_w, cout, dws[k].data_ptr(),
                dbs[k].data_ptr(), stream), f"wgrad_reduce{k + 1}")
            dense_block_bwd.launches += 1
            # conv_transpose(dz, W_k) = conv of dz with the flipped,
            # transposed weights (9, c_k, cout)
            wt = weights[k].flip(0).transpose(1, 2).contiguous()
            dz_prev = dz_act[k % 2]
            _raise_on(lib.dense_block_dgrad(
                is_bf16, dz.data_ptr(), cout, wt.data_ptr(), c_k,
                dfeats.data_ptr(), feats.data_ptr(), c_total,
                dz_prev.data_ptr(), c_k - growth if k else c_k, b, h, w,
                float(slope), stream), f"dgrad{k + 1}")
            dense_block_bwd.launches += 1
            # the epilogue left dout_{k} (f32) in x_k's slice of dfeats
            dz = dz_prev
            dout_ptr = dfeats.data_ptr() + (c_k - growth) * 4
            dout_stride = c_total
        dx = dfeats[..., :c].permute(0, 3, 1, 2).to(dtype).contiguous()
    return dx, dws, dbs


dense_block_bwd.launches = 0


class _DenseBlockTrain(torch.autograd.Function):
    """Forward saves the feature buffer; backward is the backward
    kernels.  dW comes back in the weights' dtype, db in f32."""

    @staticmethod
    def forward(ctx, x, res_scale, slope, *wb):
        weights, biases = wb[:N_CONVS], wb[N_CONVS:]
        y, feats = dense_block(x, weights, biases, res_scale=res_scale,
                               slope=slope, save_acts=True)
        ctx.save_for_backward(feats, *weights)
        ctx.res_scale, ctx.slope = res_scale, slope
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        feats, *weights = ctx.saved_tensors
        # autograd may hand over an expanded or permuted view
        dx, dws, dbs = dense_block_bwd(feats, weights, g.contiguous(),
                                       res_scale=ctx.res_scale,
                                       slope=ctx.slope)
        dws = [d.to(wk.dtype) for d, wk in zip(dws, weights)]
        return (dx, None, None, *dws, *dbs)


def dense_block_train(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor], *, res_scale: float,
                      slope: float) -> torch.Tensor:
    """The differentiable dense block: :func:`dense_block` whose gradient
    with respect to x, the packed weights and the biases is
    :func:`dense_block_bwd`.  The weights are the ones already cast to
    x's dtype inside the graph, so a float32 parameter behind them
    receives the gradient rounded to that dtype, as in the JAX package."""
    if len(weights) != N_CONVS or len(biases) != N_CONVS:
        raise ValueError(f"expected {N_CONVS} weights and biases, got "
                         f"{len(weights)} and {len(biases)}")
    return _DenseBlockTrain.apply(x, float(res_scale), float(slope),
                                  *weights, *biases)
