"""ESRGAN dense block: the hand-written Hopper kernels, forward and
backward, and their plain PyTorch versions.

:func:`dense_block` computes, on an NCHW input x of C channels with n
convs (any n >= 1; five in ESRGAN) and growth G, for k = 1..n-1
``x_k = LReLU(conv3x3(cat(x, x_1..x_{k-1})) + b_k)`` and returns
``y = x + res_scale * conv_n(cat(x, x_1..x_{n-1}))``.  It replaces the
TPU kernels ``ops/pallas/dense_block_cf.py:fused_dense_block_cf5`` and
``ops/pallas/dense_block_cf_ext.py:fused_dense_block_cf9`` of the JAX
package and keeps their calling contract (the count is
``len(weights)``, C and G are any widths) and their numerics: f32
accumulation, f32 bias, each conv output rounded to x's dtype (conv_n
before the f32 residual), y rounded to x's dtype.  With
``save_acts=True`` it also returns the feature buffer ``cat(x,
x_1..x_{n-1})``, channels-last — the buffer the kernel works in, kept as
it is for the backward (:func:`layout` gives its channels).

:func:`dense_block_bwd` is the backward from that buffer, the weights
and the cotangent of y: dx in x's dtype, dW_k (9, cout, cin) and db_k
in f32.  It replaces ``ops/pallas/dense_block_cf_vjp.py:
fused_dense_block_cf5_bwd`` and keeps its rounding points (the
cotangent of every conv is rounded to x's dtype before the two products,
db is summed from the unrounded one, dx is rounded once) and its
LeakyReLU gradient, which takes the slope branch where a saved
activation is exactly 0.  :func:`dense_block_train` is the
differentiable block — a ``torch.autograd.Function`` over the two,
named after the JAX ``dense_block_cf_train`` — and returns dW in the
weights' dtype, as the JAX VJP does.

:func:`dense_block_chain` runs a whole RRDB trunk: for each RRDB, its
dense blocks one after the other and its outer residual ``x +
res_scale * out``, value for value as :func:`dense_block` and the
compute dtype's multiply and add give them.  On the card its blocks
share three channels-last feature buffers: x is copied into the first
once, each block's last launch writes its output, with the RRDB's
residual where the block ends an RRDB, straight into channels [0, C) of
the buffer the next block reads (:func:`chain_plan`), and one copy takes
the trunk's output out to NCHW.

:func:`fused_dense_block` is the same forward on an NHWC x, returning
an NHWC y: the NHWC entry of ``csrc/dense_block.cu``, which replaces
``ops/pallas/dense_block.py:fused_dense_block`` (the ``pallas_fused``
conv path).  x lands in the channels-last feature buffer as a strided
copy, and the last launch writes y channels-last.  The Pallas kernel
rounds each tap's partial product to the compute dtype before its f32
tap sum (a VMEM saving of the TPU); the port sums the taps in f32, so
bf16 results differ from it by that rounding, and float32 agrees.

On a CUDA tensor these launch the kernels of ``csrc/dense_block.cu``
(one launch per conv, :func:`fwd_launches`) and ``csrc/dense_block_bwd.cu``
(:func:`bwd_launches`: in bf16 a prep launch, one data-gradient launch
per conv, one weight-gradient launch and one reduction; in float32, the
parity mode, three per conv) or raise; on a CPU tensor they run
:func:`dense_block_plain` and :func:`dense_block_bwd_plain`, PyTorch
convolutions in f32 with the same rounding points.  The kernels have no
band constraint, so they serve every geometry either TPU kernel served,
and also the heights the JAX package sent to lax (H not divisible by 8).

Widths.  In bf16 every slice of the feature buffer starts on a 16-byte
boundary, as TMA needs: C and G are padded to multiples of 8 inside the
buffer, with zero input channels and zero weights and biases on the
padded outputs (LeakyReLU(0) = 0), so the padded channels stay 0 and add
nothing to any sum.  The public shapes stay unpadded: x, y, dx, dW and
db.  Outputs wider than 64 channels take several channel groups of the
Hopper tile.  Float32 buffers are not padded (its kernels load scalars).

Bound of the forward at the flagship shape (8, 64, 128, 128) bf16:
62.8 GFLOP per block, about 63.5 us at 989 TFLOP/s, against about 10 us
to move its 34.0 MB at 3.35 TB/s — bound by operations; the backward is
twice the operations.  The bf16 paths run every multiply-add on the
tensor cores; the source notes in ``csrc/`` describe the designs and
PERF.md their times.

Weights are packed (:func:`pack_weight`) as (9, cout, cin) in the
compute dtype — once per model for inference, inside the graph each
forward for training; biases stay f32.  The bf16 backward re-lays them
for its data gradient with one indexed copy per block per call, from an
index built once per geometry.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from super_resolution_tpu_torch.device import no_tf32
from super_resolution_tpu_torch.metrics import count, span

N_CONVS = 5                    # convs of the ESRGAN block (any n >= 1 runs)
TILE = 16                      # the kernels' square pixel tile
WGRAD_BLOCKS = 264             # blocks an f32 wgrad launch aims for
BF16_ALIGN = 8                 # bf16 slices start on 16-byte boundaries
# the bf16 weight gradient (csrc/dense_block_bwd.cu wgrad_wgmma): units of
# 64 input x 32 output channels over ranges of 16x8-pixel tiles
WGRAD_CI, WGRAD_CO, WGRAD_TILE_ROWS = 64, 32, 8
WGRAD_SLOT = 9 * WGRAD_CI * WGRAD_CO   # floats of one unit's sums
PREP_PIXELS = 64               # pixels per bwd_prep block (its db slots)


def fwd_launches(n: int) -> int:
    """Kernel launches of one forward of an n-conv block."""
    return n


def bwd_launches(n: int, dtype: torch.dtype) -> int:
    """Kernel launches of one backward of an n-conv block: bf16 a prep,
    n data-gradient launches, the weight gradient and the reduction;
    float32 a data gradient, a weight gradient and its reduction per
    conv."""
    return n + 3 if dtype == torch.bfloat16 else 3 * n


LAUNCHES_PER_BLOCK = fwd_launches(N_CONVS)
BWD_LAUNCHES_PER_BLOCK = bwd_launches(N_CONVS, torch.bfloat16)

Grads = Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]


class Layout(NamedTuple):
    """Channels of a block's feature buffer (and of the bf16 backward's
    dz buffer): x's C, then G for each of x_1..x_{n-1}, each slice padded
    to cp and gp channels."""
    c: int
    g: int
    n: int
    cp: int
    gp: int

    @property
    def c_total(self) -> int:
        return self.cp + (self.n - 1) * self.gp

    @property
    def padded(self) -> bool:
        return (self.cp, self.gp) != (self.c, self.g)

    def offset(self, j: int) -> int:
        """First channel of slice j (x for j = 0, x_j for j >= 1); j = n
        is the end of the buffer."""
        return 0 if j == 0 else self.cp + (j - 1) * self.gp

    def positions(self, cin: int) -> np.ndarray:
        """Buffer channel of each of the first ``cin`` real channels."""
        i = np.arange(cin)
        e = np.maximum(i - self.c, 0)
        return np.where(i < self.c, i,
                        self.cp + e // max(self.g, 1) * self.gp
                        + e % max(self.g, 1))


def layout(c: int, growth: int, n: int, dtype: torch.dtype) -> Layout:
    """The feature buffer's channels for C, G and n convs in ``dtype``
    (growth is ignored for n = 1, which has no growth conv)."""
    g = growth if n > 1 else 0
    a = BF16_ALIGN if dtype == torch.bfloat16 else 1
    return Layout(c, g, n, -(-c // a) * a, -(-g // a) * a)


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


def _growth(weights: Sequence[torch.Tensor]) -> int:
    return weights[0].shape[1] if len(weights) > 1 else 0


def _check_weights(c: int, dtype: torch.dtype, device: torch.device,
                   weights: Sequence[torch.Tensor]) -> int:
    """Packed weights of a block of ``c`` channels; returns the growth."""
    if len(weights) < 1:
        raise ValueError("a dense block needs at least one conv")
    if any(wk.dim() != 3 for wk in weights):
        raise ValueError("weights must be packed (9, cout, cin) "
                         "(ops.dense_block.pack_weight)")
    growth = _growth(weights)
    if c < 1 or (len(weights) > 1 and growth < 1):
        raise ValueError(f"channels and growth must be at least 1, got "
                         f"channels={c}, growth={growth}")
    cin = c
    for k, wk in enumerate(weights):
        cout = c if k == len(weights) - 1 else growth
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
           biases: Sequence[torch.Tensor], layout_name: str = "NCHW") -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be {layout_name}, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous ({layout_name})")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights, *biases)):
        raise RuntimeError(
            "the dense-block forward has no gradient here, and an input "
            "requires one: use dense_block_train (RRDBNet.prepare(dtype, "
            "live=True) under conv_impl pallas_cf or pallas_cf_tail), or "
            "run under torch.no_grad()")
    _check_weights(x.shape[layout_name.index("C")], x.dtype, x.device,
                   weights)
    if len(biases) != len(weights):
        raise ValueError(f"expected {len(weights)} biases, got "
                         f"{len(biases)}")
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
               g: torch.Tensor) -> Layout:
    """The training entry's saved buffer and cotangent; returns the
    buffer's layout."""
    if feats.dim() != 4 or not feats.is_contiguous():
        raise ValueError(f"the saved feature buffer must be a contiguous "
                         f"(B, H, W, channels) tensor, got "
                         f"{tuple(feats.shape)}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, got "
                        f"{feats.dtype}")
    if not weights or weights[-1].dim() != 3:
        raise ValueError("weights must be packed (9, cout, cin) tensors")
    b, h, w, c_total = feats.shape
    c = weights[-1].shape[1]
    growth = _check_weights(c, feats.dtype, feats.device, weights)
    lay = layout(c, growth, len(weights), feats.dtype)
    if c_total != lay.c_total:
        raise ValueError(f"feature buffer has {c_total} channels, the "
                         f"weights say {lay.c_total} ({len(weights)} convs "
                         f"of {c} + growth {growth})")
    if tuple(g.shape) != (b, c, h, w):
        raise ValueError(f"the cotangent must be {(b, c, h, w)} like y, "
                         f"got {tuple(g.shape)}")
    if g.dtype != feats.dtype or g.device != feats.device:
        raise TypeError(f"the cotangent must be {feats.dtype} on "
                        f"{feats.device}, got {g.dtype} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("the cotangent must be contiguous (NCHW); "
                         "dense_block_train makes it so")
    return lay


def feature_buffer(x: torch.Tensor,
                   acts: Sequence[torch.Tensor]) -> torch.Tensor:
    """NCHW x and x_1..x_{n-1} -> the channels-last buffer the backward
    takes (slices padded with zeros as :func:`layout` says)."""
    lay = layout(x.shape[1], acts[0].shape[1] if acts else 0,
                 len(acts) + 1, x.dtype)
    if not lay.padded:
        return torch.cat([x, *acts], 1).permute(0, 2, 3, 1).contiguous()
    b, _, h, w = x.shape
    buf = x.new_zeros((b, h, w, lay.c_total))
    for j, t in enumerate([x, *acts]):
        buf[..., lay.offset(j):lay.offset(j) + t.shape[1]] = \
            t.permute(0, 2, 3, 1)
    return buf


def split_features(feats: torch.Tensor, c: int, growth: int
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Inverse of :func:`feature_buffer`: (x, [x_1..x_{n-1}]), NCHW."""
    lay = layout(c, growth, 2, feats.dtype)
    n = 1 + (feats.shape[-1] - lay.cp) // lay.gp \
        if feats.shape[-1] > lay.cp else 1
    lay = layout(c, growth, n, feats.dtype)
    nchw = feats.permute(0, 3, 1, 2)
    return (nchw[:, :c].contiguous(),
            [nchw[:, lay.offset(j):lay.offset(j) + growth].contiguous()
             for j in range(1, n)])


def dense_block_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor], *, res_scale: float,
                      slope: float, save_acts: bool = False):
    """The plain PyTorch version of the forward kernel: one ``F.conv2d``
    per conv in f32 (no TF32) with the kernel's rounding points.  Takes
    the kernel's packed weights.  ``save_acts=True`` returns ``(y,
    [x_1..x_{n-1}])`` like the JAX kernel."""
    dtype = x.dtype
    feats = [x.float()]
    with no_tf32():
        for k, (wk, bk) in enumerate(zip(weights, biases)):
            o = F.conv2d(torch.cat(feats, 1), unpack_weight(wk).float(),
                         bk.float(), padding=1)
            if k < len(weights) - 1:
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
    [db_k f32])`` from NCHW x, the saved x_1..x_{n-1}, the packed weights
    and the cotangent g of y.  f32 (no TF32) throughout; dout_k is
    rounded to x's dtype before the two products, db_k is summed
    before."""
    dtype = x.dtype
    n = len(weights)
    c = x.shape[1]
    growth = _growth(weights)
    feats = torch.cat([x, *acts], 1).float()
    dfeats = torch.zeros_like(feats)
    dfeats[:, :c] = g.float()              # the residual's identity
    dws = [None] * n
    dbs = [None] * n
    with no_tf32():
        for k in range(n - 1, -1, -1):
            c_k = c + k * growth
            if k == n - 1:
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
    interface (the saved feature buffer in place of x and x_1..x_{n-1})."""
    x, acts = split_features(feats, weights[-1].shape[1], _growth(weights))
    return dense_block_bwd_plain(x, acts, weights, g, res_scale=res_scale,
                                 slope=slope)


# ---- weight relayouts: one indexed copy from the flattened weights ----

def _flat_offsets(lay: Layout) -> List[int]:
    """Offset of each conv's packed (9, cout, cin) weight in the
    concatenation of all of them; the last entry is the zero's."""
    offs, cin = [0], lay.c
    for k in range(lay.n):
        cout = lay.c if k == lay.n - 1 else lay.g
        offs.append(offs[-1] + 9 * cout * cin)
        cin += lay.g
    return offs


@functools.lru_cache(maxsize=64)
def pad_index(lay: Layout) -> Tuple[np.ndarray, Tuple[Tuple[int, ...], ...]]:
    """Index of the padded forward weights: conv k's (9, cout_p, cin_p),
    real channels at their buffer positions, zeros elsewhere (the last
    conv keeps its C outputs).  Returns the concatenated flat index and
    the shapes."""
    offs = _flat_offsets(lay)
    parts, shapes, cin = [], [], lay.c
    for k in range(lay.n):
        last = k == lay.n - 1
        cout, cout_p = (lay.c, lay.c) if last else (lay.g, lay.gp)
        cin_p = lay.offset(k + 1)
        idx = np.full((9, cout_p, cin_p), offs[-1], np.int64)
        idx[:, :cout, lay.positions(cin)] = (
            offs[k] + (np.arange(9)[:, None, None] * cout
                       + np.arange(cout)[None, :, None]) * cin
            + np.arange(cin)[None, None, :])
        parts.append(idx.ravel())
        shapes.append((9, cout_p, cin_p))
        cin += lay.g
    return np.concatenate(parts), tuple(shapes)


@functools.lru_cache(maxsize=64)
def gather_index(lay: Layout) -> Tuple[np.ndarray, Tuple[Tuple[int, ...],
                                                          ...]]:
    """Index of the bf16 backward's data-gradient weights B_j, j =
    0..n-1: (9, N_j, K_j) with N_0 = C, N_j = gp, K_j = c_total - j gp.
    B_j[t, o, d] = W_k[8 - t, m, in_j + o] where dz buffer channel
    j gp + d is channel m of dz_k (conv k's output, in x_k's place for
    k < n and x's for k = n) and in_j is slice j's first channel in conv
    k's input: the tap-flipped, transposed slices of W_{j+1..n}; zero
    where m or o is a padded channel.  Returns the concatenated flat index
    and the shapes."""
    offs = _flat_offsets(lay)
    n, c, g, gp = lay.n, lay.c, lay.g, lay.gp
    parts, shapes = [], []
    for j in range(n):
        width, width_p = (c, c) if j == 0 else (g, gp)
        d = j * gp + np.arange(lay.c_total - j * gp)
        k = np.where(d < (n - 1) * gp, d // max(gp, 1) + 1, n)   # 1-based
        m = d - (k - 1) * gp
        cout = np.where(k < n, g, c)
        cin = c + (k - 1) * g
        in_j = 0 if j == 0 else c + (j - 1) * g
        t = np.arange(9)[:, None, None]
        o = np.arange(width_p)[None, :, None]
        src = (np.asarray(offs)[k - 1][None, None, :]
               + ((8 - t) * cout[None, None, :] + m[None, None, :])
               * cin[None, None, :] + in_j + o)
        ok = (m < cout)[None, None, :] & (o < width)
        parts.append(np.where(ok, src, offs[-1]).ravel())
        shapes.append((9, width_p, d.size))
    return np.concatenate(parts), tuple(shapes)


@functools.lru_cache(maxsize=64)
def _device_index(index_of, lay: Layout, device: torch.device
                  ) -> torch.Tensor:
    """``index_of``'s index on ``device``, copied there once per geometry."""
    return torch.from_numpy(index_of(lay)[0]).to(device)


def _relayout_flat(weights: Sequence[torch.Tensor], index_of,
                   lay: Layout) -> torch.Tensor:
    """The weights re-laid by ``index_of``'s index, concatenated: one
    concatenation and one indexed copy."""
    return torch.cat([w.reshape(-1) for w in weights]
                     + [weights[0].new_zeros(1)])[
        _device_index(index_of, lay, weights[0].device)]


def _starts(shapes) -> List[int]:
    """Offsets of the re-laid tensors in their concatenation."""
    return [0, *itertools.accumulate(a * b * c for a, b, c in shapes)]


def _relayout(weights: Sequence[torch.Tensor], index_of, lay: Layout
              ) -> List[torch.Tensor]:
    """:func:`_relayout_flat` as one tensor per conv (or slice)."""
    flat = _relayout_flat(weights, index_of, lay)
    shapes = index_of(lay)[1]
    return [flat[a:b].view(shape)
            for a, b, shape in zip(_starts(shapes), _starts(shapes)[1:],
                                   shapes)]


def _padded_params(weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor], lay: Layout):
    """Weights and biases at the buffer's padded widths (zero biases on
    the padded outputs)."""
    ws = _relayout(weights, pad_index, lay)
    bs = [bk if k == lay.n - 1 or lay.gp == lay.g
          else torch.cat([bk, bk.new_zeros(lay.gp - lay.g)])
          for k, bk in enumerate(biases)]
    return ws, bs


# ---- the kernels ----

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
        vp, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                        ctypes.c_longlong)
        _argtypes(lib.dense_block_dgrad,
                  [vp, i, vp, i, vp, vp, i, vp, i, i, i, i, f, vp])
        _argtypes(lib.dense_block_wgrad,
                  [vp, vp, i, vp, i, i, i, vp, i, i, i, i, vp])
        _argtypes(lib.dense_block_wgrad_reduce, [vp, i, i, i, vp, vp, vp])
        _argtypes(lib.dense_block_bwd_prep,
                  [vp, i, i, f, vp, i, vp, i, i, vp])
        _argtypes(lib.dense_block_gather,
                  [vp, i, i, vp, i, i, vp, vp, vp, ll, f, i, i, i, vp])
        _argtypes(lib.dense_block_wgrad_wgmma,
                  [vp, vp, i, i, i, i, i, i, i, i, i, vp, ll, vp])
        _argtypes(lib.dense_block_bwd_reduce,
                  [i, i, i, i, i, i, vp, vp, i, i, i, vp, i, vp, vp, vp])
    return lib


def _lib_chain() -> ctypes.CDLL:
    from super_resolution_tpu_torch.build import load_all

    # the chain launches convs 1..n-1 from the block library: both are
    # built at once
    lib = load_all(("dense_block", "dense_block_chain"))[1]
    if lib.dense_block_conv_chain.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _argtypes(lib.dense_block_conv_chain,
                  [vp, i, vp, vp, i, vp, i, i, i, i, f, vp])
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().dense_block_error_string(rc).decode()
        raise RuntimeError(f"dense_block {what}: kernel launch failed with "
                           f"CUDA error {rc} ({msg})")


def _launch_growth(lib, counter, buf: torch.Tensor, lay: Layout,
                   weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor], slope: float, stream,
                   poison: bool = False) -> None:
    """Launches 1..n-1 of a block in its channels-last feature buffer,
    each writing its slice, counted in ``counter.launches``.  ``poison``
    (a check) fills every channel from each conv's cin upward with NaN
    before its launch, so a read past cin would show in y."""
    b, h, w, _ = buf.shape
    for k in range(lay.n - 1):
        cin = lay.offset(k + 1)
        if poison:
            buf[..., cin:].fill_(float("nan"))
        rc = lib.dense_block_conv(
            int(buf.dtype == torch.bfloat16), buf.data_ptr(), lay.c_total,
            cin, weights[k].data_ptr(), biases[k].data_ptr(),
            weights[k].shape[1], buf.data_ptr() + cin * buf.element_size(),
            None, b, h, w, float(slope), 0.0, 0, 0, stream)
        _raise_on(rc, f"conv{k + 1}")
        counter.launches += 1


def _launch_block(counter, x: torch.Tensor, x_nhwc: torch.Tensor,
                  weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor], res_scale: float,
                  slope: float, nhwc: bool, poison: bool = False):
    """The n launches of one block on the card, each counted in
    ``counter.launches``: (y in x's layout, feature buffer).  ``poison``:
    see :func:`_launch_growth`."""
    lib = _lib()
    b, h, w, c = x_nhwc.shape
    n = len(weights)
    lay = layout(c, _growth(weights), n, x.dtype)
    if lay.padded:
        weights, biases = _padded_params(weights, biases, lay)
    with torch.cuda.device(x.device):
        # channels-last feature buffer: x, then each conv's output slice
        buf = torch.empty((b, h, w, lay.c_total), dtype=x.dtype,
                          device=x.device)
        buf[..., :c].copy_(x_nhwc)
        if lay.cp > c:
            buf[..., c:lay.cp].zero_()
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch_growth(lib, counter, buf, lay, weights, biases, slope,
                       stream, poison)
        rc = lib.dense_block_conv(
            int(x.dtype == torch.bfloat16), buf.data_ptr(), lay.c_total,
            lay.c_total, weights[-1].data_ptr(), biases[-1].data_ptr(), c,
            y.data_ptr(), x.data_ptr(), b, h, w, float(slope),
            float(res_scale), 1, int(nhwc), stream)
        _raise_on(rc, f"conv{n}")
        counter.launches += 1
    return y, buf


def dense_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor], *, res_scale: float,
                slope: float, save_acts: bool = False):
    """One dense block on NCHW ``x`` (float32 or bfloat16) with packed
    weights.  CUDA tensors launch the kernel (and count the launches in
    ``dense_block.launches``), inside the device span
    ``ops.dense_block``; CPU tensors take the plain version.
    ``save_acts=True`` returns ``(y, feature buffer)``."""
    _check(x, weights, biases)
    if x.device.type == "cpu":
        return plain_forward(x, weights, biases, res_scale=res_scale,
                             slope=slope, save_acts=save_acts)
    if x.device.type != "cuda":
        raise ValueError(f"dense_block runs on cuda or cpu, not {x.device}")
    with span("ops.dense_block", x.device):
        y, buf = _launch_block(dense_block, x, x.permute(0, 2, 3, 1),
                               weights, biases, res_scale, slope, nhwc=False)
    return (y, buf) if save_acts else y


dense_block.launches = 0


Block = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]
CHAIN_BUFFERS = 3
# where conv n finds x_o for the RRDB's residual (csrc/conv3x3_wgmma.cuh)
OUTER_AT_OUT, OUTER_IS_X = 1, 2


def chain_plan(n_rrdb: int, n_dense: int
               ) -> List[Tuple[int, int, Optional[int]]]:
    """The buffers of an RRDB trunk on the chain, per dense block in
    order: ``(src, dst, outer)`` among :data:`CHAIN_BUFFERS`.  The block
    reads buffer ``src``, and its last launch writes channels [0, C) of
    ``dst``, adding, where the block ends an RRDB, the residual of
    ``outer``, the RRDB's first buffer.  dst is never src (other tiles of
    the launch still read src) and never the RRDB's first buffer before
    its last block (x_o waits there); the last block writes over x_o where
    that is not its src (each value of x_o is read by the lane that then
    writes it).  The trunk's output is in the last block's dst."""
    plan, cur = [], 0
    for _ in range(n_rrdb):
        first = cur
        for j in range(n_dense):
            end = j == n_dense - 1
            dst = first if end and cur != first else \
                min(set(range(CHAIN_BUFFERS)) - {cur, first})
            plan.append((cur, dst, first if end else None))
            cur = dst
    return plan


def _check_chain(x: torch.Tensor, rrdbs: Sequence[Sequence[Block]]
                 ) -> List[Block]:
    """The trunk's blocks in order, each checked against x, all of one
    geometry, the same count in every RRDB."""
    n_dense = len(rrdbs[0])
    if n_dense < 1 or any(len(r) != n_dense for r in rrdbs):
        raise ValueError(f"every RRDB needs the same number (at least "
                         f"one) of dense blocks, got "
                         f"{[len(r) for r in rrdbs]}")
    blocks = [blk for r in rrdbs for blk in r]
    shapes = [tuple(wk.shape) for wk in blocks[0][0]]
    for weights, biases in blocks:
        _check(x, weights, biases)
        if [tuple(wk.shape) for wk in weights] != shapes:
            raise ValueError("every dense block of the trunk must have the "
                             "first one's conv count and widths")
    return blocks


def _chain_plain(x: torch.Tensor, blocks: Sequence[Block], n_dense: int,
                 res_scale: float, slope: float) -> torch.Tensor:
    """The chain on the CPU: :func:`chain_plan`'s buffers (channels-last,
    x's C channels), :func:`dense_block_plain` per block and the RRDB's
    residual in x's dtype."""
    b, c, h, w = x.shape
    bufs = x.new_empty((CHAIN_BUFFERS, b, h, w, c))
    nchw = [t.permute(0, 3, 1, 2) for t in bufs]
    bufs[0].copy_(x.permute(0, 2, 3, 1))
    count("dense_block.input_copies")
    count("dense_block.chained", len(blocks) - 1)
    for (weights, biases), (src, dst, outer) in zip(
            blocks, chain_plan(len(blocks) // n_dense, n_dense)):
        y = dense_block_plain(nchw[src].contiguous(), weights, biases,
                              res_scale=res_scale, slope=slope)
        if outer is not None:
            y = nchw[outer] + res_scale * y
        nchw[dst].copy_(y)
    return y.contiguous()


def _chain_cuda(x: torch.Tensor, blocks: Sequence[Block], n_dense: int,
                res_scale: float, slope: float) -> torch.Tensor:
    """The chain on the card: one copy of x into the first buffer, per
    block its n launches (counted in ``dense_block.launches``: convs
    1..n-1 from ``csrc/dense_block.cu``, conv n from
    ``csrc/dense_block_chain.cu``) inside its own ``ops.dense_block``
    device span, and in the last one the copy of the output to NCHW."""
    chain, lib = _lib_chain(), _lib()
    b, c, h, w = x.shape
    lay = layout(c, _growth(blocks[0][0]), len(blocks[0][0]), x.dtype)
    plan = chain_plan(len(blocks) // n_dense, n_dense)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        bufs = torch.empty((CHAIN_BUFFERS, b, h, w, lay.c_total),
                           dtype=x.dtype, device=x.device)
        for i, ((weights, biases), (src, dst, outer)) in enumerate(
                zip(blocks, plan)):
            with span("ops.dense_block", x.device):
                if i == 0:
                    if lay.cp > c:
                        bufs[..., c:lay.cp].zero_()
                    bufs[0, ..., :c].copy_(x.permute(0, 2, 3, 1))
                    count("dense_block.input_copies")
                else:
                    count("dense_block.chained")
                if lay.padded:
                    weights, biases = _padded_params(weights, biases, lay)
                _launch_growth(lib, dense_block, bufs[src], lay, weights,
                               biases, slope, stream)
                rc = chain.dense_block_conv_chain(
                    bufs[src].data_ptr(), lay.c_total,
                    weights[-1].data_ptr(), biases[-1].data_ptr(), c,
                    bufs[dst].data_ptr(),
                    0 if outer is None else
                    OUTER_AT_OUT if outer == dst else OUTER_IS_X,
                    b, h, w, float(res_scale), stream)
                _raise_on(rc, f"conv{lay.n} (chained)")
                dense_block.launches += 1
                if i == len(blocks) - 1:
                    out = bufs[dst, ..., :c].permute(0, 3, 1, 2) \
                        .contiguous()
    return out


def dense_block_chain(x: torch.Tensor, rrdbs: Sequence[Sequence[Block]], *,
                      res_scale: float, slope: float) -> torch.Tensor:
    """An RRDB trunk on NCHW ``x``: ``rrdbs`` holds, per RRDB, its dense
    blocks' ``(weights, biases)`` (packed, as :func:`dense_block` takes
    them); each RRDB gives ``x + res_scale * block_n(...block_1(x))``,
    the blocks' residuals and the RRDB's in x's dtype, equal value for
    value to :func:`dense_block` and the dtype's multiply and add.  CUDA
    tensors (bfloat16) launch the kernels on the chain's buffers
    (:func:`chain_plan`): 345 launches for 23 RRDBs of three five-conv
    blocks, one copy of x in (counter ``dense_block.input_copies``) and
    one of the output out, every other block's input written by an
    epilogue (counter ``dense_block.chained``).  CPU tensors take the
    plain version with the same buffers and counters."""
    if not rrdbs:
        return x
    blocks = _check_chain(x, rrdbs)
    if x.device.type == "cpu":
        return _chain_plain(x, blocks, len(rrdbs[0]), res_scale, slope)
    if x.device.type != "cuda":
        raise ValueError(f"dense_block_chain runs on cuda or cpu, not "
                         f"{x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the chain's kernel runs bfloat16, got {x.dtype}: "
                        f"run the blocks one by one (dense_block)")
    return _chain_cuda(x, blocks, len(rrdbs[0]), res_scale, slope)


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


def wgrad_parts(n_pixel_tiles: int, cin: int) -> int:
    """Workspace slots (pixel-tile ranges) of one float32 wgrad launch:
    enough blocks to fill the card, a function of the shapes alone, so
    the reduction order and the result repeat bit for bit."""
    chunks = -(-cin // 16)
    return min(n_pixel_tiles, max(1, -(-WGRAD_BLOCKS // chunks)))


def wgrad_jobs(lay: Layout) -> int:
    """(conv, 64-channel input chunk, 32-channel output group) jobs of the
    bf16 weight gradient (``wgrad_jobs`` in csrc/dense_block_bwd.cu)."""
    jobs = 0
    for k in range(lay.n):
        cout = lay.cp if k == lay.n - 1 else lay.gp
        jobs += -(-lay.offset(k + 1) // WGRAD_CI) * -(-cout // WGRAD_CO)
    return jobs


def wgrad_ranges(n_tiles: int, jobs: int, n_sm: int) -> int:
    """Pixel ranges per job of the bf16 weight gradient: about two units
    per SM (one per consumer warpgroup), never more ranges than tiles — a
    function of the shapes and the SM count alone, so the partition of
    every sum repeats bit for bit."""
    return max(1, min(n_tiles, 2 * n_sm // jobs))


def _tile_n(width: int) -> int:
    """The Hopper tile's N for ``width`` output channels (``pick_n`` in
    csrc/conv3x3_wgmma.cuh, groups of 64 above)."""
    return 8 if width <= 8 else 16 if width <= 16 else 32 if width <= 32 \
        else 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_bf16(feats: torch.Tensor, weights: Sequence[torch.Tensor],
              g: torch.Tensor, lay: Layout, res_scale: float,
              slope: float) -> Grads:
    """The bf16 backward on the card (csrc/dense_block_bwd.cu): the prep,
    the gathers j = n-1..0, the weight gradient, the reduction."""
    lib = _lib_bwd()
    b, h, w, ct = feats.shape
    c, gw, n, cp, gp = lay
    dev = feats.device
    ptr = feats.data_ptr()

    def count(rc: int, what: str) -> None:
        _raise_on(rc, what)
        dense_block_bwd.launches += 1

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # B_0..B_{n-1}: the tensor stays referenced while the kernels use it
        bmat = _relayout_flat(weights, gather_index, lay)
        b_ptr = bmat.data_ptr()
        b_at = _starts(gather_index(lay)[1])
        dz = torch.empty_like(feats)
        dz_ptr = dz.data_ptr()
        dx = torch.empty((b, c, h, w), dtype=feats.dtype, device=dev)
        # one f32 workspace: the gathers' db slots (per slice g_groups x
        # g_slots x g_n), bwd_prep's db slots, wgrad_wgmma's unit sums
        g_n = _tile_n(gp) if gp else 1
        g_groups = _cdiv(gp, g_n)
        g_slots = 4 * b * _cdiv(h, TILE) * _cdiv(w, TILE)
        per_slice = g_groups * g_slots * g_n
        p_slots = b * _cdiv(h * w, PREP_PIXELS)
        jobs = wgrad_jobs(lay)
        ranges = wgrad_ranges(b * _cdiv(h, WGRAD_TILE_ROWS) * _cdiv(w, TILE),
                              jobs, _sm_count(dev.index))
        at_prep = (n - 1) * per_slice
        at_wgrad = at_prep + p_slots * cp
        work = torch.empty(at_wgrad + jobs * ranges * WGRAD_SLOT,
                           dtype=torch.float32, device=dev)
        w_ptr = work.data_ptr()
        count(lib.dense_block_bwd_prep(
            g.data_ptr(), c, cp, float(res_scale), dz_ptr + (n - 1) * gp * 2,
            ct, w_ptr + at_prep * 4, b, h * w, stream), "prep")
        for j in range(n - 1, 0, -1):
            count(lib.dense_block_gather(
                dz_ptr, ct, j * gp, b_ptr + b_at[j] * 2, gp, 1,
                dz_ptr + (j - 1) * gp * 2, ptr + lay.offset(j) * 2,
                w_ptr + (j - 1) * per_slice * 4, per_slice, float(slope), b,
                h, w, stream), f"gather{j}")
        count(lib.dense_block_gather(
            dz_ptr, ct, 0, b_ptr, c, 0, dx.data_ptr(), g.data_ptr(), None, 0,
            float(slope), b, h, w, stream), "gather0")
        count(lib.dense_block_wgrad_wgmma(
            ptr, dz_ptr, c, gw, cp, gp, n, b, h, w, ranges,
            w_ptr + at_wgrad * 4, jobs * ranges, stream), "wgrad")
        sizes = [9 * (c if k == n - 1 else gw) * (c + k * gw)
                 for k in range(n)]
        dw = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        db = torch.empty((n - 1) * gw + c, dtype=torch.float32, device=dev)
        count(lib.dense_block_bwd_reduce(
            c, gw, cp, gp, n, ranges, w_ptr + at_wgrad * 4, w_ptr, g_slots,
            g_n, g_groups, w_ptr + at_prep * 4, p_slots, dw.data_ptr(),
            db.data_ptr(), stream), "reduce")
    dws = [d.view(wk.shape) for d, wk in zip(dw.split(sizes), weights)]
    dbs = list(db.split([gw] * (n - 1) + [c]))
    return dx, dws, dbs


def _bwd_f32(feats: torch.Tensor, weights: Sequence[torch.Tensor],
             g: torch.Tensor, lay: Layout, res_scale: float,
             slope: float) -> Grads:
    """The float32 backward on the card: per conv k = n..1 the weight
    gradient, its reduction and the data gradient into an f32 dfeats
    buffer (csrc/dense_block_bwd.cu, the f32 kernels)."""
    lib = _lib_bwd()
    b, h, w, c_total = feats.shape
    c, growth, n = lay.c, lay.g, lay.n
    dev = feats.device
    n_tiles = b * _cdiv(h, TILE) * _cdiv(w, TILE)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        g_last = g.permute(0, 2, 3, 1)                 # (B, H, W, C) view
        dfeats = torch.zeros((b, h, w, c_total), dtype=torch.float32,
                             device=dev)
        dfeats[..., :c].copy_(g_last)                  # residual identity
        # the last conv's cotangent, channels-last
        dz = (g_last * res_scale).contiguous()
        dout_ptr, dout_stride = dz.data_ptr(), c
        # dz of convs n-1..1, written by the dgrad epilogue of the conv above
        dz_act = [torch.empty((b, h, w, growth), dtype=feats.dtype,
                              device=dev) for _ in range(2)]
        dws, dbs = [None] * n, [None] * n
        for k in range(n - 1, -1, -1):
            c_k = c + k * growth
            cout = weights[k].shape[1]
            n_w = 9 * cout * c_k
            parts = wgrad_parts(n_tiles, c_k)
            work = torch.empty((parts, n_w + cout), dtype=torch.float32,
                               device=dev)
            _raise_on(lib.dense_block_wgrad(
                dz.data_ptr(), dout_ptr, dout_stride, feats.data_ptr(),
                c_total, c_k, cout, work.data_ptr(), parts, b, h, w,
                stream), f"wgrad{k + 1}")
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
                dz.data_ptr(), cout, wt.data_ptr(), c_k, dfeats.data_ptr(),
                feats.data_ptr(), c_total, dz_prev.data_ptr(),
                c_k - growth if k else c_k, b, h, w, float(slope), stream),
                f"dgrad{k + 1}")
            dense_block_bwd.launches += 1
            # the epilogue left dout_{k} in x_k's slice of dfeats
            dz = dz_prev
            dout_ptr = dfeats.data_ptr() + (c_k - growth) * 4
            dout_stride = c_total
        dx = dfeats[..., :c].permute(0, 3, 1, 2).contiguous()
    return dx, dws, dbs


def dense_block_bwd(feats: torch.Tensor, weights: Sequence[torch.Tensor],
                    g: torch.Tensor, *, res_scale: float,
                    slope: float) -> Grads:
    """Backward of one dense block from the forward's saved feature
    buffer (``dense_block(..., save_acts=True)``), the packed weights
    and the NCHW cotangent ``g`` of y: ``(dx, [dW_k (9, cout, cin) f32],
    [db_k f32])``.  CUDA tensors launch the backward kernels (counted in
    ``dense_block_bwd.launches``, inside the device span
    ``ops.dense_block_bwd``) or raise — bf16 the Hopper design,
    float32 (the parity mode) its own kernels; this is the one place the
    two part — CPU tensors take :func:`dense_block_bwd_plain`."""
    lay = _check_bwd(feats, weights, g)
    if feats.device.type == "cpu":
        return plain_backward(feats, weights, g, res_scale=res_scale,
                              slope=slope)
    if feats.device.type != "cuda":
        raise ValueError(f"dense_block_bwd runs on cuda or cpu, not "
                         f"{feats.device}")
    run = _bwd_bf16 if feats.dtype == torch.bfloat16 else _bwd_f32
    with span("ops.dense_block_bwd", feats.device):
        return run(feats, weights, g, lay, res_scale, slope)


dense_block_bwd.launches = 0


class _DenseBlockTrain(torch.autograd.Function):
    """Forward saves the feature buffer; backward is the backward
    kernels.  dW comes back in the weights' dtype, db in f32."""

    @staticmethod
    def forward(ctx, x, res_scale, slope, *wb):
        n = len(wb) // 2
        weights, biases = wb[:n], wb[n:]
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
    if not weights or len(weights) != len(biases):
        raise ValueError(f"expected as many weights as biases (at least "
                         f"one), got {len(weights)} and {len(biases)}")
    return _DenseBlockTrain.apply(x, float(res_scale), float(slope),
                                  *weights, *biases)
