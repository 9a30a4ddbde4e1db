"""The JAX package's experiment dense-block kernels, on Hopper.

``ops/pallas/experiments_dense_block.py`` of the JAX package keeps five
retired TPU kernels of the ESRGAN dense block, each behind its own
contract: NCHW x, HWIO weights (any count n = ``len(weights)``, any
channel and growth widths), f32 biases, a keyword band height ``rows``
(``h % rows == 0 and rows >= 5``, a ``ValueError`` here),
``res_scale`` and ``slope``.  No product dispatch reaches them; the
port's tools do (``tools.kernel_bench``, ``tools.model_bench``,
``tools.kernel_dev_check``).

- :func:`fused_dense_block_cf` (v3), :func:`fused_dense_block_cf2`
  (v3b), :func:`fused_dense_block_cf3` (v4, default ``rows=32``, with
  ``save_acts``) and :func:`fused_dense_block_cf6` (v6) compute the
  function of ``ops.dense_block.dense_block`` and round where it rounds:
  each conv accumulates in f32, adds its f32 bias and the LeakyReLU in
  f32 and is rounded to x's dtype; conv5 is rounded before the f32
  residual.  They differ from the shipping kernel v5 only in how they
  fed the TPU's matrix unit from VMEM: taps packed in M with a 3-D
  contraction, a 2-D flattened band, one packed-K scratch, a
  dy-extended K = 3C operand.  The Hopper implicit GEMM of
  ``csrc/dense_block.cu`` already contracts over all nine taps and the
  whole channel prefix in K, so each routes to that kernel (five
  launches per call, counted on the wrapper) and no second CUDA kernel
  exists for them.  ``rows`` only tiled the TPU's work: it is checked
  and changes no value.
- :func:`fused_dense_block_cf8` (v8) is another function: dynamic int8
  quantization with band-local scales, int32 sums.  Weights are
  quantized per packed row (``pack_weights_v6``'s (3F, 3C) layout, row
  dx·F + f) with scale ``max(max|row|, 1e-12) / 127``; each conv's input
  window is quantized with one scale per (image, band) from its amax;
  the three dx partial products are dequantized apart and summed
  ``((left + mid) + right) + b`` in f32, ``left + mid`` as one FMA.  A
  band recomputes its 2n halo rows with its own scales, so the result
  depends on ``rows``.  On a CUDA tensor it launches
  ``csrc/dense_block_int8.cu`` (an amax kernel and an int8 ``mma.sync``
  conv kernel per conv: 2n launches), with C and G padded to multiples
  of 8 inside its banded buffer and the weights, whose zeros change no
  amax, no weight scale (an all-zero row gets the JAX kernel's scale
  ``1e-12 / 127`` and quantizes to 0) and no int32 sum; on a CPU tensor
  it runs :func:`fused_dense_block_cf8_plain`.

Two steps follow what XLA makes of the JAX kernel (checked against it
in interpret mode on the CPU): ``x / 127.0`` is folded into a
multiplication by the float32 constant 1/127, and the dequantized middle
tap is contracted into the shift-add, ``fma(A_1, s_w·s_x, left)``.  Both
versions here multiply by that constant and take that one FMA; every
other f32 step rounds on its own.  So float32 results equal the JAX
kernel's, and a quantized value never rounds the other way (which moves
y by about 1e-3).

Bound of the int8 block at (8, 64, 128, 128) bf16, ``rows=16``, counting
the band recompute: Σ_k out_rows_k·cin_k·cout_k·9·2·W·B·n_bands ≈ 71.9
GOP, about 0.036 ms at 1,979 TOP/s, against 33.6 MB of x and y, about
0.010 ms at 3.35 TB/s: bound by operations.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.ops.dense_block import (
    N_CONVS,
    _check,
    _launch_block,
    _padded_params,
    dense_block_plain,
    layout,
    pack_weight,
    split_features,
    unpack_weight,
)


def int8_launches(n: int) -> int:
    """Launches of one v8 call with n convs: an amax and a conv each."""
    return 2 * n


INT8_LAUNCHES_PER_CALL = int8_launches(N_CONVS)
INT8_CHUNK = 32                # channels per int8 mma step (k32)
# float32 1/127: XLA's fold of the JAX kernel's ``/ 127.0``
RECIP127 = float(torch.tensor(1.0) / torch.tensor(127.0))


def pack_weights_v6(w_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, F) HWIO -> (3F, 3C): row dx·F + f, col dy·C + c."""
    k_h, k_w, c, f = w_hwio.shape
    if (k_h, k_w) != (3, 3):
        raise ValueError(f"expected a 3x3 HWIO kernel, got "
                         f"{tuple(w_hwio.shape)}")
    return w_hwio.permute(1, 3, 0, 2).reshape(3 * f, 3 * c)


def _check_rows(x: torch.Tensor, rows: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW, got {tuple(x.shape)}")
    if rows < 5 or x.shape[2] % rows:
        raise ValueError(f"the band height must divide H and be at least "
                         f"5: H={x.shape[2]}, rows={rows}")


def _packed(x: torch.Tensor, weights: Sequence[torch.Tensor],
            biases: Sequence[torch.Tensor]):
    """HWIO weights packed (9, cout, cin) in x's dtype, f32 biases, as
    the JAX kernels cast them."""
    if not weights or len(weights) != len(biases):
        raise ValueError(f"expected as many weights as biases (at least "
                         f"one), got {len(weights)} and {len(biases)}")
    return ([pack_weight(w.permute(3, 2, 0, 1)).to(x.dtype)
             for w in weights],
            [b.to(torch.float32).contiguous() for b in biases])


def _routed(counter, x: torch.Tensor, weights: Sequence[torch.Tensor],
            biases: Sequence[torch.Tensor], rows: int, res_scale: float,
            slope: float, save_acts: bool = False):
    """One of v3–v6: the dense-block kernel of ``csrc/dense_block.cu``
    on a CUDA tensor (one launch per conv, counted in
    ``counter.launches``), its plain version on a CPU tensor.
    ``save_acts`` returns ``(y, [x_1..x_{n-1}])``, NCHW."""
    _check_rows(x, rows)
    wp, bp = _packed(x, weights, biases)
    _check(x, wp, bp)
    if x.device.type == "cpu":
        return dense_block_plain(x, wp, bp, res_scale=res_scale,
                                 slope=slope, save_acts=save_acts)
    if x.device.type != "cuda":
        raise ValueError(f"{counter.__name__} runs on cuda or cpu, not "
                         f"{x.device}")
    y, buf = _launch_block(counter, x, x.permute(0, 2, 3, 1), wp, bp,
                           res_scale, slope, nhwc=False)
    if save_acts:
        return y, split_features(buf, x.shape[1], wp[0].shape[1]
                                 if len(wp) > 1 else 0)[1]
    return y


def fused_dense_block_cf(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], *, rows: int = 16,
                         res_scale: float = 0.2,
                         slope: float = 0.2) -> torch.Tensor:
    """v3: x (B, C, H, W), weights[k] (3, 3, C_k, C_k_out) HWIO.  Returns
    (B, C, H, W): x + res_scale·conv_n([x, x1..x_{n-1}])."""
    return _routed(fused_dense_block_cf, x, weights, biases, rows,
                   res_scale, slope)


def fused_dense_block_cf2(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor], *, rows: int = 16,
                          res_scale: float = 0.2,
                          slope: float = 0.2) -> torch.Tensor:
    """v3b; the contract of :func:`fused_dense_block_cf`."""
    return _routed(fused_dense_block_cf2, x, weights, biases, rows,
                   res_scale, slope)


def fused_dense_block_cf3(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor], *, rows: int = 32,
                          res_scale: float = 0.2, slope: float = 0.2,
                          save_acts: bool = False):
    """v4; the contract of :func:`fused_dense_block_cf`.  With
    ``save_acts`` also returns ``[a1..a_{n-1}]``, (B, growth, H, W)
    each."""
    return _routed(fused_dense_block_cf3, x, weights, biases, rows,
                   res_scale, slope, save_acts)


def fused_dense_block_cf6(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor], *, rows: int = 16,
                          res_scale: float = 0.2,
                          slope: float = 0.2) -> torch.Tensor:
    """v6; the contract of :func:`fused_dense_block_cf`."""
    return _routed(fused_dense_block_cf6, x, weights, biases, rows,
                   res_scale, slope)


for _fn in (fused_dense_block_cf, fused_dense_block_cf2,
            fused_dense_block_cf3, fused_dense_block_cf6):
    _fn.launches = 0


def quantize_weights(weights: Sequence[torch.Tensor]
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """v8's weight preparation: per conv the packed (3F, 3C) weights
    rounded to integers in [-127, 127] (held as float32) and the (3F,)
    float32 scale of each row."""
    wqs, sws = [], []
    for wk in weights:
        wp = pack_weights_v6(wk).float()
        s = wp.abs().amax(1).clamp_min(1e-12) * RECIP127
        wqs.append(torch.round(wp / s[:, None]).clamp(-127.0, 127.0))
        sws.append(s)
    return wqs, sws


def _bands(x: torch.Tensor, rows: int, halo: int) -> torch.Tensor:
    """x (B, C, H, W) -> its bands (B, n_bands, C, rows + 2 halo, W),
    zero rows above and below the image (a view of one padded copy)."""
    band_rows = rows + 2 * halo
    xp = F.pad(x, (0, 0, halo, halo))
    return xp.unfold(2, band_rows, rows).permute(0, 2, 1, 4, 3)


def _check_int8(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor], rows: int) -> int:
    """v8's inputs; returns the growth."""
    _check_rows(x, rows)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NCHW)")
    if not weights or len(weights) != len(biases):
        raise ValueError(f"expected as many weights as biases (at least "
                         f"one), got {len(weights)} and {len(biases)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights, *biases)):
        raise RuntimeError("the int8 dense block has no gradient, and an "
                           "input requires one: run under torch.no_grad()")
    c = x.shape[1]
    growth = weights[0].shape[-1] if len(weights) > 1 else 0
    cin = c
    for k, (wk, bk) in enumerate(zip(weights, biases)):
        cout = c if k == len(weights) - 1 else growth
        if tuple(wk.shape) != (3, 3, cin, cout):
            raise ValueError(f"conv{k + 1} weight must be HWIO "
                             f"(3, 3, {cin}, {cout}), got "
                             f"{tuple(wk.shape)}")
        if tuple(bk.shape) != (cout,):
            raise ValueError(f"conv{k + 1} bias must be ({cout},), got "
                             f"{tuple(bk.shape)}")
        if wk.device != x.device or bk.device != x.device:
            raise ValueError(f"conv{k + 1}: weights and biases must be on "
                             f"{x.device}")
        cin += growth
    return growth


def fused_dense_block_cf8_plain(x: torch.Tensor,
                                weights: Sequence[torch.Tensor],
                                biases: Sequence[torch.Tensor], *,
                                rows: int = 16, res_scale: float = 0.2,
                                slope: float = 0.2) -> torch.Tensor:
    """The plain PyTorch version of v8, step by step as the JAX kernel
    takes them, all bands at once: quantized operands are integers held
    in float32 and their products are summed by ``torch.matmul``, which
    is exact while every partial sum stays below 2^24 (3·C_k·127², C_k up
    to 346 input channels; TF32 off), and in float64 for wider convs;
    the int32 sum then rounds to float32 as the kernels convert it."""
    _check_int8(x, weights, biases, rows)
    b, c, h, w = x.shape
    n = halo = len(weights)
    n_bands, band_rows = h // rows, rows + 2 * halo
    dtype = x.dtype
    wqs, sws = quantize_weights(weights)
    bands = _bands(x, rows, halo)                 # (B, nb, C, rows+2n, W)
    feats = bands.float()
    band_row0 = torch.arange(n_bands, device=x.device) * rows
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for k in range(n):
            last = k == n - 1
            cout = wqs[k].shape[0] // 3
            out_rows = band_rows - 2 * k - 2
            win = feats[:, :, :, k:band_rows - k]    # (B, nb, C_k, out+2, W)
            s_x = win.abs().amax((2, 3, 4)).clamp_min(1e-6) * RECIP127
            q = torch.round(win * torch.reciprocal(s_x)[..., None, None,
                                                         None])
            q = q.clamp(-127.0, 127.0)
            ext = torch.cat([q[:, :, :, dy:dy + out_rows]
                             for dy in range(3)], 2)
            exact = torch.float32 if 3 * q.shape[2] * 127 ** 2 < 2 ** 24 \
                else torch.float64
            acc = torch.matmul(wqs[k].to(exact), ext.flatten(3).to(exact)) \
                .float()                                  # (B, nb, 3F, M)
            acc = acc.reshape(b, n_bands, 3, cout, out_rows, w)
            scale = (sws[k].reshape(3, cout)
                     * s_x[..., None, None])[..., None, None]
            accf = acc * scale
            left = F.pad(accf[:, :, 0, ..., :-1], (1, 0))
            right = F.pad(accf[:, :, 2, ..., 1:], (0, 1))
            # fma(A_1, scale_1, left): the product is exact in float64,
            # the sum rounds once to float32
            mid = (acc[:, :, 1].double() * scale[:, :, 1].double()
                   + left.double()).float()
            out = mid + right + biases[k].float()[:, None, None]
            if not last:
                out = torch.where(out >= 0, out, slope * out)
            g_row = (band_row0[:, None] - (halo - k - 1)
                     + torch.arange(out_rows, device=x.device))
            inside = (g_row >= 0) & (g_row < h)
            out = torch.where(inside[None, :, None, :, None], out, 0.0)
            out = out.to(dtype).float()
            if not last:
                full = out.new_zeros((b, n_bands, cout, band_rows, w))
                full[:, :, :, k + 1:k + 1 + out_rows] = out
                feats = torch.cat([feats, full], 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    x_center = bands[:, :, :, halo:halo + rows].float()
    y = (x_center + res_scale * out).to(dtype)      # (B, nb, C, rows, W)
    return y.permute(0, 2, 1, 3, 4).reshape(b, c, h, w)


def _lib_int8() -> ctypes.CDLL:
    from super_resolution_tpu_torch.build import load

    lib = load("dense_block_int8")
    if lib.dense_block_int8_conv.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dense_block_int8_amax.argtypes = [i, vp, i, i, i, i, i, i, i,
                                              vp, vp]
        lib.dense_block_int8_amax.restype = i
        lib.dense_block_int8_conv.argtypes = [
            i, vp, i, i, i, i, vp, i, vp, vp, i, vp, vp, i, i, i, i, i, f,
            f, i, vp, vp]
        lib.dense_block_int8_conv.restype = i
        lib.dense_block_int8_error_string.argtypes = [i]
        lib.dense_block_int8_error_string.restype = ctypes.c_char_p
    return lib


def kernel_weights(wq: torch.Tensor, cout: int) -> Tuple[torch.Tensor, int]:
    """(3F, 3C) quantized weights -> the kernel's int8 (3 dy, 3 dx, F,
    C_pad), channels zero-padded to a multiple of 32; returns it and
    C_pad."""
    c = wq.shape[1] // 3
    c_pad = -(-c // INT8_CHUNK) * INT8_CHUNK
    w4 = wq.reshape(3, cout, 3, c).permute(2, 0, 1, 3)
    return F.pad(w4, (0, c_pad - c)).to(torch.int8).contiguous(), c_pad


def fused_dense_block_cf8(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor], *, rows: int = 16,
                          res_scale: float = 0.2,
                          slope: float = 0.2) -> torch.Tensor:
    """v8, the int8 dense block with dynamic quantization; the contract
    of :func:`fused_dense_block_cf`.  On a CUDA tensor the kernels of
    ``csrc/dense_block_int8.cu`` (2n launches, counted in
    ``fused_dense_block_cf8.launches``) or an error; on a CPU tensor
    :func:`fused_dense_block_cf8_plain`."""
    growth = _check_int8(x, weights, biases, rows)
    if x.device.type == "cpu":
        return fused_dense_block_cf8_plain(x, weights, biases, rows=rows,
                                           res_scale=res_scale, slope=slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense_block_cf8 runs on cuda or cpu, not "
                         f"{x.device}")
    lib = _lib_int8()
    b, c, h, w = x.shape
    n = halo = len(weights)
    n_bands, band_rows = h // rows, rows + 2 * halo
    # 8-channel pieces in both dtypes: the layout of a bf16 buffer
    lay = layout(c, growth, n, torch.bfloat16)
    is_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        if lay.padded:
            # at the buffer's widths: each real channel at its place,
            # zero rows, columns and biases elsewhere
            wp, biases = _padded_params(
                [pack_weight(w.permute(3, 2, 0, 1)) for w in weights],
                biases, lay)
            weights = [unpack_weight(w).permute(2, 3, 1, 0) for w in wp]
        wqs, sws = quantize_weights(weights)
        bias = [bk.float().contiguous() for bk in biases]
        # the banded channels-last buffer: x in channels [0, C), then each
        # conv's slice, band by band (a band's halo rows are its own)
        buf = torch.empty((b, n_bands, band_rows, w, lay.c_total),
                          dtype=x.dtype, device=x.device)
        buf[..., :c].copy_(_bands(x, rows, halo).permute(0, 1, 3, 4, 2))
        if lay.cp > c:
            buf[..., c:lay.cp].zero_()
        amax = torch.zeros((n, b * n_bands), dtype=torch.int32,
                           device=x.device)
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for k in range(n):
            last = k == n - 1
            cin = lay.offset(k + 1)          # conv k's padded input
            cout = wqs[k].shape[0] // 3
            wq8, c_pad = kernel_weights(wqs[k], cout)
            rc = lib.dense_block_int8_amax(
                is_bf16, buf.data_ptr(), lay.c_total, cin, k, halo, rows,
                b * n_bands, w, amax[k].data_ptr(), stream)
            _raise_int8(lib, rc, f"amax{k + 1}")
            fused_dense_block_cf8.launches += 1
            rc = lib.dense_block_int8_conv(
                is_bf16, buf.data_ptr(), lay.c_total, cin, k, halo,
                wq8.data_ptr(), c_pad, sws[k].data_ptr(), bias[k].data_ptr(),
                cout, y.data_ptr(), x.data_ptr(), b, n_bands, rows, h, w,
                float(slope), float(res_scale), int(last),
                amax[k].data_ptr(), stream)
            _raise_int8(lib, rc, f"conv{k + 1}")
            fused_dense_block_cf8.launches += 1
    return y


fused_dense_block_cf8.launches = 0


def _raise_int8(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.dense_block_int8_error_string(rc).decode()
        raise RuntimeError(f"fused_dense_block_cf8 {what}: kernel launch "
                           f"failed with CUDA error {rc} ({msg})")
