"""Shifted-window multi-head self-attention of a Swin layer: the
hand-written Hopper kernel and its plain PyTorch version.

SwinIR (arXiv 2108.10257; ``models/swinir.py``) attends within 8×8
windows of the feature map, every other layer over windows shifted by
half a window.  Per window and head, as SwinIR's ``WindowAttention``::

    attn = softmax(q · hd^-½ · kᵀ + B_rel[head] + mask) · v

with ``B_rel`` gathered from the relative-position table by the published
relative-position index (:func:`relative_position_index`) and, in a
shifted layer, ``mask`` −100.0 between tokens of different regions of
``calculate_mask``'s 3 × 3 cut of the shifted frame
(:func:`shift_mask`).  The shifted layer rolls the map by −s before the
window partition and back after.

:func:`window_attention` takes the qkv Linear's (B, Hp, Wp, 3C) output,
channels ordered (3, heads, hd) as SwinIR reshapes them, and returns the
(B, Hp, Wp, C) attention output at the same pixels, from the table laid
out (heads, (2w−1)²) in float32 (SwinIR's ((2w−1)², heads) parameter
transposed, once, when the model is prepared): the roll, partition,
reverse and roll back are the kernel's addressing, ``csrc/
window_attention.cu`` (one launch a layer, ``window_attention.launches``;
bf16, float32 softmax, P rounded to bf16 for P·v, head dim padded to 32
with zeros on chip).  On a CPU tensor it runs
:func:`window_attention_plain`: float32, TF32 off, ``torch.roll``, the
partition and the same math.  While recording (:mod:`metrics`) a launch
is the device span ``ops.window_attention`` and counts
``window_attention.windows`` (windows × heads) and
``window_attention.shifted`` (launches with a shift).

Bound of one SwinIR-L layer at 1024² (8 heads of 30): 64.4 GFLOP, 65 µs
at 989 TFLOP/s, against 1.51 GB of qkv read and 0.50 GB written, 0.60 ms
at 3.35 TB/s: bound by bytes.
"""

from __future__ import annotations

import ctypes

import torch

from super_resolution_tpu_torch.device import no_tf32
from super_resolution_tpu_torch.metrics import count, span

WINDOW = 8           # the window side of every SwinIR SR release
TABLE_ROWS = (2 * WINDOW - 1) ** 2
MASK_VALUE = -100.0  # calculate_mask's fill


def relative_position_index() -> torch.Tensor:
    """SwinIR's ``relative_position_index``: (w², w²) int64, token n =
    (yn, xn) against m: (yn − ym + w − 1)·(2w − 1) + (xn − xm + w − 1)."""
    coords = torch.stack(torch.meshgrid(torch.arange(WINDOW),
                                        torch.arange(WINDOW),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (WINDOW - 1)
    return rel[..., 0] * (2 * WINDOW - 1) + rel[..., 1]


def relative_bias(table: torch.Tensor) -> torch.Tensor:
    """(heads, w², w²) bias from a (heads, (2w−1)²) table."""
    n = WINDOW * WINDOW
    idx = relative_position_index().to(table.device).view(-1)
    return table[:, idx].view(-1, n, n)


def shift_mask(hp: int, wp: int, shift: int, device=None) -> torch.Tensor:
    """``calculate_mask`` of SwinIR: (nW, w², w²) float32, 0 within a
    region and −100.0 across regions, windows in row-major order."""
    window = WINDOW
    img = torch.zeros((hp, wp), device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for ws in cuts:
            img[hs, ws] = cnt
            cnt += 1
    win = img.view(hp // window, window, wp // window, window)
    win = win.permute(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, torch.tensor(MASK_VALUE, device=device),
                       torch.tensor(0.0, device=device))


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           heads: int, shift: int) -> torch.Tensor:
    """The plain version: float32 (TF32 off) roll, partition, attention
    with the relative bias and the shift mask, reverse and roll back;
    ``table`` (heads, (2w−1)²).  Returns x's dtype."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    window = WINDOW
    nwy, nwx = hp // window, wp // window
    n = window * window
    x = qkv.float()
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    x = x.view(b, nwy, window, nwx, window, 3, heads, hd)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, nwy * nwx, heads,
                                                  n, hd)
    q, k, v = x[0], x[1], x[2]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with no_tf32():
            attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
            attn = attn + relative_bias(table.float())[None, None]
            if shift:
                attn = attn + shift_mask(hp, wp, shift,
                                         qkv.device)[None, :, None]
            o = torch.softmax(attn, dim=-1) @ v
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    o = o.view(b, nwy, nwx, heads, window, window, hd)
    o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, hp, wp, c)
    if shift:
        o = torch.roll(o, shifts=(shift, shift), dims=(1, 2))
    return o.to(qkv.dtype)


def _lib() -> ctypes.CDLL:
    from super_resolution_tpu_torch.build import load

    lib = load("window_attention")
    if lib.window_attention_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.window_attention_launch.argtypes = [vp, vp, vp, i, i, i, i, i, i,
                                                ctypes.c_float, vp]
        lib.window_attention_launch.restype = ctypes.c_int
        lib.window_attention_error_string.argtypes = [i]
        lib.window_attention_error_string.restype = ctypes.c_char_p
    return lib


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                     shift: int) -> torch.Tensor:
    """One Swin layer's window attention on the qkv Linear's (B, Hp, Wp,
    3C) output (Hp, Wp multiples of ``WINDOW``); ``table`` is the
    relative-position table, (heads, (2w−1)²) float32, w = ``WINDOW``.  A
    CUDA tensor (bf16) launches the kernel; a CPU tensor runs
    :func:`window_attention_plain`."""
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (B, Hp, Wp, 3 * heads * hd), got "
                         f"{tuple(qkv.shape)} for {heads} heads")
    b, hp, wp, c3 = qkv.shape
    if hp % WINDOW or wp % WINDOW:
        raise ValueError(f"the map ({hp} x {wp}) must be a multiple of the "
                         f"window {WINDOW}")
    if not 0 <= shift < WINDOW:
        raise ValueError(f"shift {shift} outside [0, {WINDOW})")
    count("window_attention.windows", b * (hp // WINDOW) * (wp // WINDOW)
          * heads)
    if shift:
        count("window_attention.shifted")
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, table, heads, shift)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention runs on cuda or cpu, not "
                         f"{qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 qkv, got {qkv.dtype}")
    if (table.dtype != torch.float32 or not table.is_contiguous()
            or tuple(table.shape) != (heads, TABLE_ROWS)):
        raise ValueError(f"the table must be a contiguous float32 "
                         f"({heads}, {TABLE_ROWS}) tensor, got "
                         f"{table.dtype} {tuple(table.shape)}")
    qkv = qkv.contiguous()
    lib = _lib()
    hd = c3 // 3 // heads
    with span("ops.window_attention", qkv.device), \
            torch.cuda.device(qkv.device):
        out = torch.empty((b, hp, wp, c3 // 3), dtype=qkv.dtype,
                          device=qkv.device)
        rc = lib.window_attention_launch(
            qkv.data_ptr(), out.data_ptr(), table.data_ptr(), b, hp, wp,
            heads, hd, shift, float(hd ** -0.5),
            torch.cuda.current_stream(qkv.device).cuda_stream)
        if rc != 0:
            msg = lib.window_attention_error_string(rc).decode()
            raise RuntimeError(f"window_attention: kernel launch failed "
                               f"with CUDA error {rc} ({msg})")
        window_attention.launches += 1
    return out


window_attention.launches = 0
