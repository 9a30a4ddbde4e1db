"""Device-side augmentation, LR synthesis and normalisation (the JAX
package's ``data/augment.py``).  The host only decodes and crops uint8
patches; uint8 -> float, flip/rot augmentation, the antialiased bicubic
/4 and the ImageNet normalisation run on the batch's device.  All
arithmetic is float32, in the JAX package's order, so the uint8 result
of :func:`to_uint8_image` is the same bit for bit given the same model
output; ``torch.round`` rounds half to even like ``jnp.round``.

The flip/rot decisions come from an explicit ``torch.Generator``, whose
stream is not ``jax.random``'s: the same seed draws other decisions, so
tests inject them (``decisions=``).  Under data parallelism every rank
draws the decisions of the whole global batch from its identically
seeded generator and keeps its own rows (``part=``), so the global
batch is augmented as one process would augment it."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from super_resolution_tpu_torch.config import DataConfig
from super_resolution_tpu_torch.ops.resize import bicubic_downsample

Decisions = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def denormalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return x * std + mean


def to_uint8_image(x_normalized: torch.Tensor,
                   cfg: DataConfig) -> torch.Tensor:
    """Denormalise a model output back to a displayable uint8 image."""
    x = denormalize(x_normalized, cfg.normalize_mean, cfg.normalize_std)
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def draw_decisions(generator: torch.Generator, batch: int) -> Decisions:
    """Per-sample (hflip, vflip, rot90) booleans, each with p = 0.5, drawn
    on the generator's device."""
    draws = torch.rand((3, batch), generator=generator,
                       device=generator.device) < 0.5
    return draws[0], draws[1], draws[2]


def augment_batch(x: torch.Tensor, decisions: Decisions) -> torch.Tensor:
    """Per-sample horizontal flip, vertical flip and 90° rotation (a
    transpose) of NHWC ``x``.  The rotation needs square patches and is
    left out for others."""
    do_h, do_v, do_r = (d.to(x.device)[:, None, None, None]
                        for d in decisions)
    x = torch.where(do_h, x.flip(2), x)
    x = torch.where(do_v, x.flip(1), x)
    if x.shape[1] == x.shape[2]:
        x = torch.where(do_r, x.transpose(1, 2), x)
    return x


def preprocess_batch(batch, cfg: DataConfig,
                     generator: Optional[torch.Generator] = None,
                     augment: Optional[bool] = None,
                     decisions: Optional[Decisions] = None,
                     part: Tuple[int, int] = (0, 1),
                     ) -> Dict[str, torch.Tensor]:
    """uint8 batch -> normalised ``{"lr", "hr"}`` training pair on the
    batch's device.  ``batch`` is an HR tensor (B, H, W, 3), from which
    LR is bicubic-synthesised, or a paired ``{"hr", "lr"}`` dict, whose
    two resolutions get the same per-sample flip/rot decisions.  The
    decisions are ``decisions`` if given, else drawn from ``generator``:
    with ``part=(index, count)`` the batch is rows [index·B, (index+1)·B)
    of a global batch of count·B rows, whose decisions are drawn and
    these rows' kept."""
    do_aug = cfg.augment if augment is None else augment
    paired = isinstance(batch, dict)
    hr = (batch["hr"] if paired else batch).float() / 255.0
    if do_aug and decisions is None:
        if generator is None:
            raise ValueError("augmentation needs a torch.Generator or "
                             "explicit decisions")
        index, count = part
        b = hr.shape[0]
        decisions = tuple(d[index * b:(index + 1) * b]
                          for d in draw_decisions(generator, b * count))
    if do_aug:
        hr = augment_batch(hr, decisions)
    if paired:
        lr = batch["lr"].float() / 255.0
        if do_aug:
            lr = augment_batch(lr, decisions)
    else:
        lr = bicubic_downsample(hr, cfg.scale)
    return {"lr": normalize(lr, cfg.normalize_mean, cfg.normalize_std),
            "hr": normalize(hr, cfg.normalize_mean, cfg.normalize_std)}
