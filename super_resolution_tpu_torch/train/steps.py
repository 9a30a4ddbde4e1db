"""The inference step (the counterpart of the JAX package's
``train/steps.py:make_infer_fn``).  The training steps come with the
training slice."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from super_resolution_tpu_torch.config import InferConfig
from super_resolution_tpu_torch.device import resolve_device
from super_resolution_tpu_torch.models.rrdb import RRDBNet

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: InferConfig) -> torch.dtype:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {cfg.compute_dtype!r}")
    return _DTYPES[cfg.compute_dtype]


def make_infer_fn(cfg: InferConfig, state_dict: Dict[str, torch.Tensor],
                  device: str | torch.device = "cuda"
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Normalised NHWC LR → normalised NHWC SR forward of the generator
    with ``state_dict`` (the port's float32 names, loaded strictly), built
    on ``device`` and cast to ``cfg.compute_dtype`` once, here."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg)
    model = RRDBNet(cfg.generator)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(device).eval().prepare(dtype)

    def infer(lr: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(lr)

    return infer
