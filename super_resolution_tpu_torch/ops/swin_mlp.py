"""A transformer layer's MLP branch, ``fc2(GELU(fc1(h)))``: the
hand-written Hopper kernel and its plain PyTorch version.

SwinIR (``models/swinir.py``) runs the branch once per Swin layer on the
LayerNorm's output ``h`` (B, H, W, E), channels last, with the hidden
width rE (480 for SwinIR-L's E 240).  :func:`swin_mlp` computes::

    y = bf16(bf16(GELU(h · W1ᵀ + b1)) · W2ᵀ + b2)

with both products summed in float32 and GELU the exact erf form in
float32.  A CUDA tensor launches ``csrc/swin_mlp.cu``: the hidden never
reaches device memory and is rounded once, as the second product's
operand (PyTorch's three calls round it after fc1 and after GELU).  The
kernel takes bf16 tensors and E a multiple of 4 up to 240 with a hidden
width up to 2048 (:func:`kernel_takes`: every SwinIR release, E 60, 180
and 240), its weights as :func:`kernel_weights` lays them out once; a
CUDA tensor it does not take raises, with no fallback.  A CPU tensor
runs :func:`swin_mlp_plain`, PyTorch's ``F.linear``, ``F.gelu``,
``F.linear``, so a CPU forward is the one it was before the kernel, bit
for bit.

``swin_mlp.launches`` counts the kernel's launches.  While recording
(:mod:`metrics`) every call counts its tokens in ``swin_mlp.tokens``,
the plain version's too.

Bound of one SwinIR-L call at 1024² LR (1,048,576 tokens): 4·E·rE =
460,800 FLOP a token, 0.4886 ms at 989 TFLOP/s, against 960 bytes a
token (h read, y written), 0.300 ms at 3.35 TB/s: bound by operations.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.metrics import count

MAX_E = 240          # the second product's widest N: SwinIR-L's E
MAX_HIDDEN = 2048    # the first bias in shared memory


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def kernel_takes(e: int, hidden: int) -> bool:
    """Whether the kernel computes an MLP of these widths: E a multiple
    of 4 (the add-and-LayerNorm kernel's rows) within fc2's N, and a
    hidden width, rounded up to 8, within b1's room."""
    return (e % 4 == 0 and 4 <= e <= MAX_E
            and 1 <= hidden and _round8(hidden) <= MAX_HIDDEN)


def kernel_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor) -> tuple:
    """An MLP's weights (nn.Linear's: W1 (hidden, E), W2 (E, hidden)) as
    :func:`swin_mlp` takes them on ``w1``'s device.  On the card W1's
    rows gain zero columns to E8, E rounded up to 8, and the hidden width
    zero rows of W1 and b1 and zero columns of W2 to a multiple of 8, so
    that each row is whole 16 bytes (a TMA tensor map); a zero hidden
    channel adds GELU(0) · 0 = 0, so the function is the same.  Made
    once, when the model is prepared: SwinIR-L's 240 and 480 need no
    copy.  CPU tensors are returned as they are.  Raises on the card for
    widths the kernel does not take."""
    if w1.device.type == "cpu":
        return w1, b1, w2, b2
    hidden, e = w1.shape
    if not kernel_takes(e, hidden):
        raise ValueError(f"the MLP kernel takes E a multiple of 4 up to "
                         f"{MAX_E} and a hidden width up to {MAX_HIDDEN}, "
                         f"got {e} and {hidden}")
    return _padded(w1, b1, w2, b2)


def _padded(w1, b1, w2, b2) -> tuple:
    (hidden, e), dh = w1.shape, _round8(w1.shape[0]) - w1.shape[0]
    if dh or e % 8:
        w1 = F.pad(w1, (0, _round8(e) - e, 0, dh))
        b1 = F.pad(b1, (0, dh))
        w2 = F.pad(w2, (0, dh))
    return w1, b1, w2, b2


def swin_mlp_plain(h: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.linear``, ``F.gelu`` (erf), ``F.linear`` in
    the tensors' dtype."""
    count("swin_mlp.tokens", h.numel() // h.shape[-1])
    return F.linear(F.gelu(F.linear(h, w1, b1)), w2, b2)


def _check(h, w1, b1, w2, b2) -> None:
    e = h.shape[-1] if h.dim() else 0
    hidden = w1.shape[0] if w1.dim() == 2 else 0
    # the card's W1 rows as kernel_weights pads them
    ew = _round8(e) if h.device.type == "cuda" else e
    for name, t, shape in (("w1", w1, (hidden, ew)), ("b1", b1, (hidden,)),
                           ("w2", w2, (e, hidden)), ("b2", b2, (e,))):
        if tuple(t.shape) != shape or not hidden:
            raise ValueError(f"{name} must be {shape} for h "
                             f"{tuple(h.shape)} and w1 {tuple(w1.shape)}, "
                             f"got {tuple(t.shape)}")
    for name, t in (("h", h), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if not t.is_contiguous():
            raise ValueError(f"swin_mlp takes contiguous tensors; {name} "
                             f"is not")
        if t.device != h.device:
            raise ValueError(f"{name} on {t.device}, h on {h.device}")


def _lib() -> ctypes.CDLL:
    from super_resolution_tpu_torch.build import load

    lib = load("swin_mlp")
    if lib.swin_mlp_launch.argtypes is None:
        vp = ctypes.c_void_p
        lib.swin_mlp_launch.argtypes = [vp, vp, vp, vp, vp, vp,
                                        ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, vp]
        lib.swin_mlp_launch.restype = ctypes.c_int
        lib.swin_mlp_error_string.argtypes = [ctypes.c_int]
        lib.swin_mlp_error_string.restype = ctypes.c_char_p
    return lib


def swin_mlp(h: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``fc2(GELU(fc1(h)))`` over the last dimension of ``h`` (…, E):
    ``w1`` (rE, E), ``b1`` (rE,), ``w2`` (E, rE), ``b2`` (E,), as
    :func:`kernel_weights` gives them.  A CUDA tensor (bf16 throughout,
    widths :func:`kernel_takes`) launches the kernel; a CPU tensor runs
    :func:`swin_mlp_plain`."""
    _check(h, w1, b1, w2, b2)
    if h.device.type == "cpu":
        return swin_mlp_plain(h, w1, b1, w2, b2)
    if h.device.type != "cuda":
        raise ValueError(f"swin_mlp runs on cuda or cpu, not {h.device}")
    if any(t.dtype != torch.bfloat16 for t in (h, w1, b1, w2, b2)):
        raise TypeError(f"the kernel takes bf16 tensors, got {h.dtype} h "
                        f"and {w1.dtype} weights")
    e, hidden = h.shape[-1], w1.shape[0]
    if not kernel_takes(e, hidden) or hidden % 8:
        raise ValueError(f"the kernel takes E a multiple of 4 up to {MAX_E} "
                         f"and a hidden width a multiple of 8 up to "
                         f"{MAX_HIDDEN}, got {e} and {hidden}")
    tokens = h.numel() // e
    lib = _lib()
    with torch.cuda.device(h.device):
        y = torch.empty_like(h)
        rc = lib.swin_mlp_launch(
            h.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), tokens, e, hidden,
            torch.cuda.current_stream(h.device).cuda_stream)
        if rc != 0:
            msg = lib.swin_mlp_error_string(rc).decode()
            raise RuntimeError(f"swin_mlp: kernel launch failed with CUDA "
                               f"error {rc} ({msg})")
    swin_mlp.launches += bool(tokens)     # none for an empty h
    count("swin_mlp.tokens", tokens)
    return y


swin_mlp.launches = 0
