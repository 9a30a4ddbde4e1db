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
  ``csrc/dense_block_int8.cu``: one weight-prep launch for all convs
  (:func:`prep_weights_plain` is its plain version), one banding launch
  of x (:func:`band_plain`), and one int8 ``wgmma`` conv per conv, whose
  epilogue gathers the row maxima from which the next conv takes its
  amax (:func:`fused_amax_plain`): n + 2 launches.  C and G are padded
  to multiples of 8 inside the banded buffer and the weights, whose
  zeros change no amax, no weight scale (an all-zero row gets the JAX
  kernel's scale ``1e-12 / 127`` and quantizes to 0) and no int32 sum.
  On a CPU tensor it runs :func:`fused_dense_block_cf8_plain`.

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
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.ops.dense_block import (
    N_CONVS,
    Layout,
    _check,
    _launch_block,
    dense_block_plain,
    layout,
    pack_weight,
    split_features,
)


def int8_launches(n: int) -> int:
    """Launches of one v8 call with n convs: the weight prep, the banding
    of x, and one conv each."""
    return n + 2


INT8_LAUNCHES_PER_CALL = int8_launches(N_CONVS)
INT8_CHUNK = 32                # channels per int8 wgmma K step (k32)
INT8_MAX_CONVS = 64            # convs of one weight-prep launch (csrc)
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
    """v8's weight quantization, as the JAX kernel takes it: per conv the
    packed (3F, 3C) weights rounded to integers in [-127, 127] (held as
    float32) and the (3F,) float32 scale of each row."""
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


def band_row_max(t: torch.Tensor) -> torch.Tensor:
    """(B, n_bands, C, band_rows, W) -> (B·n_bands, band_rows): each band
    row's max |v| over channels and width, in float32."""
    b, nb, _, band_rows, _ = t.shape
    return t.float().abs().amax((2, 4)).reshape(b * nb, band_rows)


def fused_amax_plain(row_max: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version of the conv's fused amax: ``row_max`` (n slices,
    B·n_bands, band_rows) holds each slice's row maxima (slice 0 x, slice
    j the output of conv j - 1); conv k's amax is the max of slices
    0..k over band rows [k, band_rows - k).  Returns (B·n_bands,)."""
    band_rows = row_max.shape[2]
    return row_max[:k + 1, :, k:band_rows - k].amax((0, 2))


def fused_dense_block_cf8_plain(x: torch.Tensor,
                                weights: Sequence[torch.Tensor],
                                biases: Sequence[torch.Tensor], *,
                                rows: int = 16, res_scale: float = 0.2,
                                slope: float = 0.2,
                                record: Optional[dict] = None
                                ) -> torch.Tensor:
    """The plain PyTorch version of v8, step by step as the JAX kernel
    takes them, all bands at once: quantized operands are integers held
    in float32 and their products are summed by ``torch.matmul``, which
    is exact while every partial sum stays below 2^24 (3·C_k·127², C_k up
    to 346 input channels; TF32 off), and in float64 for wider convs;
    the int32 sum then rounds to float32 as the kernels convert it.

    ``record``, if given, receives ``window_amax``: per conv the amax of
    its input window as the JAX kernel takes it, (B·n_bands,) each, and
    ``row_max``: (n, B·n_bands, band_rows), the row maxima of each slice
    as the kernels' epilogues gather them (slice j + 1 from conv j's
    stored output, zero outside the rows it writes)."""
    _check_int8(x, weights, biases, rows)
    b, c, h, w = x.shape
    n = halo = len(weights)
    n_bands, band_rows = h // rows, rows + 2 * halo
    dtype = x.dtype
    wqs, sws = quantize_weights(weights)
    bands = _bands(x, rows, halo)                 # (B, nb, C, rows+2n, W)
    feats = bands.float()
    row_max = [band_row_max(feats)]
    window_amax = []
    band_row0 = torch.arange(n_bands, device=x.device) * rows
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for k in range(n):
            last = k == n - 1
            cout = wqs[k].shape[0] // 3
            out_rows = band_rows - 2 * k - 2
            win = feats[:, :, :, k:band_rows - k]    # (B, nb, C_k, out+2, W)
            amax = win.abs().amax((2, 3, 4))
            window_amax.append(amax.reshape(-1))
            s_x = amax.clamp_min(1e-6) * RECIP127
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
                row_max.append(band_row_max(full))
                feats = torch.cat([feats, full], 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    if record is not None:
        record["window_amax"] = window_amax
        record["row_max"] = torch.stack(row_max)
    x_center = bands[:, :, :, halo:halo + rows].float()
    y = (x_center + res_scale * out).to(dtype)      # (B, nb, C, rows, W)
    return y.permute(0, 2, 1, 3, 4).reshape(b, c, h, w)


# ---- the CUDA path: csrc/dense_block_int8.cu ----

def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


class Int8Conv(NamedTuple):
    """Conv k's operands in the scratch buffer (byte offsets) and its
    widths: it reads the buffer prefix ``cin_p`` and writes ``cout_p``
    channels (the last conv: C); its int8 weights are (9, cout_p,
    cpad)."""
    wq_off: int
    sw_off: int
    bias_off: int
    cin_p: int
    cout_p: int
    cpad: int


class Int8Scratch(NamedTuple):
    """The one scratch buffer of a call: the amax array (n slices,
    B·n_bands, band_rows) uint32 at offset 0, then each conv's weights,
    scales and biases, each region aligned to 256 bytes."""
    convs: Tuple[Int8Conv, ...]
    amax_words: int
    nbytes: int


@functools.lru_cache(maxsize=64)
def int8_scratch(lay: Layout, n_bb: int, band_rows: int) -> Int8Scratch:
    """Where the weight-prep launch writes conv k's operands."""
    n = lay.n
    words = n * n_bb * band_rows
    off = _round_up(4 * words, 256)
    convs = []
    for k in range(n):
        last = k == n - 1
        cin_p = lay.offset(k + 1)
        cout_p = lay.c if last else lay.gp
        cpad = _round_up(cin_p, INT8_CHUNK)
        wq = off
        off = _round_up(off + 9 * cout_p * cpad, 256)
        sw = off
        off = _round_up(off + 4 * 3 * cout_p, 256)
        bias = off
        off = _round_up(off + 4 * cout_p, 256)
        convs.append(Int8Conv(wq, sw, bias, cin_p, cout_p, cpad))
    return Int8Scratch(tuple(convs), words, off)


def prep_weights_plain(weights: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor], lay: Layout
                       ) -> List[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]]:
    """The plain version of the weight-prep launch: per conv its int8
    (9, cout_p, cpad) weights (tap dy·3 + dx; each real input channel at
    its buffer position, zeros elsewhere), its (3·cout_p,) float32 scales
    (row dx·cout_p + f; padded rows get 1e-12/127) and its (cout_p,)
    float32 biases (0 on padded outputs)."""
    scratch = int8_scratch(lay, 1, 1)
    wqs, sws = quantize_weights(weights)
    zero_scale = torch.full((), 1e-12, dtype=torch.float32) * RECIP127
    out = []
    for k, (wq, s, bk) in enumerate(zip(wqs, sws, biases)):
        conv = scratch.convs[k]
        cout, cin = wq.shape[0] // 3, wq.shape[1] // 3
        # (dx, f, dy, c) -> (dy, dx, f, c)
        w4 = wq.reshape(3, cout, 3, cin).permute(2, 0, 1, 3)
        q = torch.zeros((3, 3, conv.cout_p, conv.cpad), dtype=torch.int8,
                        device=wq.device)
        pos = torch.from_numpy(lay.positions(cin)).to(wq.device)
        q[:, :, :cout, pos] = w4.to(torch.int8)
        sw = zero_scale.to(wq.device).repeat(3, conv.cout_p)
        sw[:, :cout] = s.reshape(3, cout)
        bias = torch.zeros(conv.cout_p, dtype=torch.float32,
                           device=wq.device)
        bias[:cout] = bk.float()
        out.append((q.reshape(9, conv.cout_p, conv.cpad), sw.reshape(-1),
                    bias))
    return out


def band_plain(x: torch.Tensor, rows: int, lay: Layout
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the banding launch: the buffer's slice 0,
    (B·n_bands, band_rows, W, cp) in x's dtype (zero rows outside the
    image, zero channels [C, cp)), and amax slice 0, (B·n_bands,
    band_rows) float32 row maxima of |x|."""
    b, c, h, w = x.shape
    bands = _bands(x, rows, lay.n)                   # (B, nb, C, br, W)
    nb, br = bands.shape[1], bands.shape[3]
    buf = x.new_zeros((b * nb, br, w, lay.cp))
    buf[..., :c] = bands.permute(0, 1, 3, 4, 2).reshape(b * nb, br, w, c)
    return buf, band_row_max(bands)


class _PrepArgs(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p * INT8_MAX_CONVS),
                ("b", ctypes.c_void_p * INT8_MAX_CONVS),
                ("ws", (ctypes.c_int * 4) * INT8_MAX_CONVS),
                ("wq_off", ctypes.c_longlong * INT8_MAX_CONVS),
                ("sw_off", ctypes.c_longlong * INT8_MAX_CONVS),
                ("bias_off", ctypes.c_longlong * INT8_MAX_CONVS),
                ("scratch", ctypes.c_void_p),
                ("n", ctypes.c_int), ("c", ctypes.c_int),
                ("g", ctypes.c_int), ("cp", ctypes.c_int),
                ("gp", ctypes.c_int), ("w_bf16", ctypes.c_int)]


def _lib_int8() -> ctypes.CDLL:
    from super_resolution_tpu_torch.build import load

    lib = load("dense_block_int8")
    if lib.dense_block_int8_conv.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dense_block_int8_prep.argtypes = [vp, vp]
        lib.dense_block_int8_prep.restype = i
        lib.dense_block_int8_band.argtypes = [i, vp, vp, vp] + [i] * 9 + [vp]
        lib.dense_block_int8_band.restype = i
        lib.dense_block_int8_conv.argtypes = [
            i, vp, i, i, i, i, vp, i, vp, vp, i, vp, vp, i, i, i, i, i, f,
            f, i, vp, vp]
        lib.dense_block_int8_conv.restype = i
        lib.dense_block_int8_plan.argtypes = [i, i, i,
                                              ctypes.POINTER(ctypes.c_int)]
        lib.dense_block_int8_plan.restype = i
        lib.dense_block_int8_error_string.argtypes = [i]
        lib.dense_block_int8_error_string.restype = ctypes.c_char_p
    return lib


def _raise_int8(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.dense_block_int8_error_string(rc).decode()
        raise RuntimeError(f"fused_dense_block_cf8 {what}: kernel launch "
                           f"failed with CUDA error {rc} ({msg})")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def int8_prep(counter, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor], lay: Layout,
              scratch: torch.Tensor, plan: Int8Scratch) -> None:
    """The weight-prep launch on the card: every conv's int8 weights,
    scales and biases into ``scratch`` at ``plan``'s offsets (one launch,
    counted in ``counter.launches``)."""
    if lay.n > INT8_MAX_CONVS:
        raise ValueError(f"the int8 block's CUDA path takes at most "
                         f"{INT8_MAX_CONVS} convs, got {lay.n}")
    w_bf16 = all(wk.dtype == torch.bfloat16 for wk in weights)
    wdt = torch.bfloat16 if w_bf16 else torch.float32
    # no copy for weights of one dtype (read through their strides: an
    # HWIO view of OIHW weights is read as it is) and f32 biases
    ws = [wk if wk.dtype == wdt else wk.to(wdt) for wk in weights]
    bs = [bk if bk.dtype == torch.float32 and bk.is_contiguous()
          else bk.to(torch.float32).contiguous() for bk in biases]
    a = _PrepArgs()
    for k, (wk, bk, conv) in enumerate(zip(ws, bs, plan.convs)):
        a.w[k], a.b[k] = wk.data_ptr(), bk.data_ptr()
        a.ws[k][:] = wk.stride()
        a.wq_off[k], a.sw_off[k], a.bias_off[k] = (conv.wq_off, conv.sw_off,
                                                   conv.bias_off)
    a.scratch = scratch.data_ptr()
    a.n, a.c, a.g, a.cp, a.gp, a.w_bf16 = (lay.n, lay.c, lay.g, lay.cp,
                                           lay.gp, int(w_bf16))
    lib = _lib_int8()
    _raise_int8(lib, lib.dense_block_int8_prep(ctypes.byref(a),
                                               _stream(scratch)), "prep")
    counter.launches += 1


def int8_band(counter, x: torch.Tensor, rows: int, lay: Layout,
              buf: torch.Tensor, amax: torch.Tensor) -> None:
    """The banding launch on the card: x into ``buf``'s slice 0 and its
    row maxima into ``amax`` slice 0, the other slices zeroed (one
    launch, counted in ``counter.launches``)."""
    b, c, h, w = x.shape
    lib = _lib_int8()
    _raise_int8(lib, lib.dense_block_int8_band(
        int(x.dtype == torch.bfloat16), x.data_ptr(), buf.data_ptr(),
        amax.data_ptr(), b, c, h, w, rows, lay.n, lay.cp, lay.c_total,
        lay.n, _stream(x)), "band")
    counter.launches += 1


def fused_dense_block_cf8(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor], *, rows: int = 16,
                          res_scale: float = 0.2,
                          slope: float = 0.2) -> torch.Tensor:
    """v8, the int8 dense block with dynamic quantization; the contract
    of :func:`fused_dense_block_cf`.  On a CUDA tensor the kernels of
    ``csrc/dense_block_int8.cu`` (n + 2 launches, counted in
    ``fused_dense_block_cf8.launches``) or an error; on a CPU tensor
    :func:`fused_dense_block_cf8_plain`."""
    growth = _check_int8(x, weights, biases, rows)
    if x.device.type == "cpu":
        return fused_dense_block_cf8_plain(x, weights, biases, rows=rows,
                                           res_scale=res_scale, slope=slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense_block_cf8 runs on cuda or cpu, not "
                         f"{x.device}")
    b, c, h, w = x.shape
    n = halo = len(weights)
    n_bands, band_rows = h // rows, rows + 2 * halo
    # 8-channel pieces in both dtypes: the layout of a bf16 buffer
    lay = layout(c, growth, n, torch.bfloat16)
    plan = int8_scratch(lay, b * n_bands, band_rows)
    counter = fused_dense_block_cf8
    with torch.cuda.device(x.device):
        buf = torch.empty((b * n_bands, band_rows, w, lay.c_total),
                          dtype=x.dtype, device=x.device)
        scratch = torch.empty(plan.nbytes, dtype=torch.uint8,
                              device=x.device)
        y = torch.empty_like(x)
        int8_prep(counter, weights, biases, lay, scratch, plan)
        int8_band(counter, x, rows, lay, buf, scratch)
        lib = _lib_int8()
        base, stream = scratch.data_ptr(), _stream(x)
        for k, conv in enumerate(plan.convs):
            rc = lib.dense_block_int8_conv(
                int(x.dtype == torch.bfloat16), buf.data_ptr(), lay.c_total,
                conv.cin_p, k, halo, base + conv.wq_off, conv.cpad,
                base + conv.sw_off, base + conv.bias_off, conv.cout_p,
                y.data_ptr(), x.data_ptr(), b, n_bands, rows, h, w,
                float(slope), float(res_scale), int(k == n - 1), base,
                stream)
            _raise_int8(lib, rc, f"conv{k + 1}")
            counter.launches += 1
    return y


fused_dense_block_cf8.launches = 0


def int8_plan(cout: int, cin: int, dtype: torch.dtype) -> dict:
    """The int8 conv's plan on the card for cout, cin (buffer channels)
    and x's dtype: N, unit rows, stages, weights resident, dynamic shared
    memory."""
    lib = _lib_int8()
    out = (ctypes.c_int * 5)()
    rc = lib.dense_block_int8_plan(cout, cin, int(dtype == torch.bfloat16),
                                   out)
    _raise_int8(lib, rc, f"plan {cin} -> {cout}")
    return dict(zip(("n", "unit_rows", "stages", "weights_resident",
                     "smem_bytes"), list(out)))
