"""Device selection and float32 precision for the port.

Entry points run on the card unless the caller asks for the CPU; asking
for CUDA where there is none raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device(name)``, refusing a CUDA device that is not there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} was asked for but torch sees no CUDA device "
            f"(torch {torch.__version__}); pass device='cpu' (CLI: "
            f"--device cpu) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {name!r}")
    return device


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions in full float32: cuDNN defaults to TF32 for
    them, which keeps about three decimal digits.  Matches the JAX
    package's ``Precision.HIGHEST`` for float32 (models/rrdb.py
    ``precision_for``).  Only the TF32 switch is touched (the
    ``cudnn.flags`` context would also reset ``enabled``)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
