"""A residual add into a token stream and the LayerNorm that reads the
stream next: the hand-written Hopper kernel and its plain PyTorch
version.

A transformer layer adds each branch back into its stream, and the next
LayerNorm reads that stream straight back (SwinIR, ``models/swinir.py``:
108 of its 118 adds a forward).  :func:`add_layernorm` does both in one
pass over the rows of the last dimension::

    s = x + branch                       (x's dtype)
    h = LayerNorm(s) · weight + bias     (statistics in float32)

and returns ``(s, h)``; with ``branch=None`` it normalises ``x`` alone
and returns ``h``.  A CUDA tensor (bf16, channels last, contiguous)
launches ``csrc/add_layernorm.cu``: ``s`` is PyTorch's bf16 add bit for
bit, ``h`` within one bf16 ULP of ``F.layer_norm`` (the mean and the
sum of squares are summed in another order).  A CPU tensor runs
:func:`add_layernorm_plain`, PyTorch's own add and ``F.layer_norm``, so
a CPU forward is the one it was before the kernel, bit for bit.  C is
a multiple of 4 up to 1024 (240 for SwinIR-L, 180 for -M, 60 for the
lightweight model); anything else raises.

``add_layernorm.launches`` counts the kernel's launches.  While
recording (:mod:`metrics`) every call counts ``add_layernorm.calls`` and
a call with a branch ``add_layernorm.fused``, the plain version's too (a
CPU forward shows the counts the card's has).

Bound of one SwinIR-L add at 1024² LR (1,048,576 rows of 240 bf16):
x and the branch read, s and h written, 2.01 GB at 3.35 TB/s, 0.60 ms;
without a branch 1.01 GB, 0.30 ms.  About 10 FLOP an element: bound by
bytes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.metrics import count

MAX_C = 1024         # the kernel keeps a row in one warp's registers


def add_layernorm_plain(x: torch.Tensor, branch: Optional[torch.Tensor],
                        weight: torch.Tensor, bias: torch.Tensor,
                        eps: float):
    """The plain version: PyTorch's add, then ``F.layer_norm`` over the
    last dimension; ``(s, h)``, or ``h`` without a branch."""
    s = x if branch is None else x + branch
    h = F.layer_norm(s, (s.shape[-1],), weight, bias, eps)
    return h if branch is None else (s, h)


def _check(x, branch, weight, bias) -> None:
    c = x.shape[-1] if x.dim() else 0
    if c % 4 or not 4 <= c <= MAX_C:
        raise ValueError(f"add_layernorm takes rows of a multiple of 4 "
                         f"channels up to {MAX_C}, got {tuple(x.shape)}")
    if branch is not None and branch.shape != x.shape:
        raise ValueError(f"branch {tuple(branch.shape)} is not x's shape "
                         f"{tuple(x.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
    for name, t in (("x", x), ("branch", branch), ("weight", weight),
                    ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"add_layernorm takes contiguous tensors; "
                             f"{name} is not")
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")


def _lib() -> ctypes.CDLL:
    from super_resolution_tpu_torch.build import load

    lib = load("add_layernorm")
    if lib.add_layernorm_launch.argtypes is None:
        vp = ctypes.c_void_p
        lib.add_layernorm_launch.argtypes = [vp, vp, vp, vp, vp, vp,
                                             ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_float, vp]
        lib.add_layernorm_launch.restype = ctypes.c_int
        lib.add_layernorm_error_string.argtypes = [ctypes.c_int]
        lib.add_layernorm_error_string.restype = ctypes.c_char_p
    return lib


def add_layernorm(x: torch.Tensor, branch: Optional[torch.Tensor],
                  weight: torch.Tensor, bias: torch.Tensor, eps: float
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``(x + branch, LayerNorm(x + branch))`` over the last dimension,
    or ``LayerNorm(x)`` when ``branch`` is None; ``weight`` and ``bias``
    (C,).  A CUDA tensor (bf16 throughout) launches the kernel; a CPU
    tensor runs :func:`add_layernorm_plain`."""
    _check(x, branch, weight, bias)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"add_layernorm runs on cuda or cpu, not "
                         f"{x.device}")
    if x.device.type == "cuda" and any(
            t is not None and t.dtype != torch.bfloat16
            for t in (x, branch, weight, bias)):
        raise TypeError("the kernel takes bf16 tensors, got "
                        f"{x.dtype} x and {weight.dtype} weight")
    if x.device.type == "cpu":
        out = add_layernorm_plain(x, branch, weight, bias, eps)
    else:
        out = _launch(x, branch, weight, bias, eps)
    count("add_layernorm.calls")
    if branch is not None:
        count("add_layernorm.fused")
    return out


def _launch(x, branch, weight, bias, eps):
    lib = _lib()
    with torch.cuda.device(x.device):
        h = torch.empty_like(x)
        s = None if branch is None else torch.empty_like(x)
        rc = lib.add_layernorm_launch(
            x.data_ptr(), None if branch is None else branch.data_ptr(),
            weight.data_ptr(), bias.data_ptr(),
            None if s is None else s.data_ptr(), h.data_ptr(),
            x.numel() // x.shape[-1], x.shape[-1], float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            msg = lib.add_layernorm_error_string(rc).decode()
            raise RuntimeError(f"add_layernorm: kernel launch failed with "
                               f"CUDA error {rc} ({msg})")
    add_layernorm.launches += 1
    return h if s is None else (s, h)


add_layernorm.launches = 0
