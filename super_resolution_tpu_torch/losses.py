"""ESRGAN loss suite as plain functions on tensors (the JAX package's
``losses.py``).

Total generator loss: ``lambda_percep * L_percep + lambda_adv * L_RaGAN +
lambda_pixel * L1``.  ``detach()`` stands where the JAX code has
``stop_gradient``.  The batch means of the relativistic losses and the
feature-matching normaliser are over the global batch: under data
parallelism the local means are averaged over the ranks
(:func:`parallel.dp.global_mean`, differentiable), as the JAX package's
sharded step makes them mesh-global.  Every other mean here is a rank's
own: the averaged gradients and logged losses make it global.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.parallel.dp import global_mean


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def psnr_of_mse(mse_: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(max_val ** 2 / mse_.clamp_min(1e-12))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    return psnr_of_mse(mse(pred, target), max_val)


def _bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Numerically stable BCEWithLogits against a constant 0/1 target:
    log(1 + exp(-|x|)) + max(x, 0) - x * target."""
    return (F.softplus(-logits.abs()) + logits.clamp_min(0.0)
            - logits * target).mean()


def _batch_mean(logits: torch.Tensor) -> torch.Tensor:
    return global_mean(logits.mean(0, keepdim=True))


def ragan_generator_loss(real_logits: torch.Tensor,
                         fake_logits: torch.Tensor) -> torch.Tensor:
    """Relativistic-average adversarial loss, generator side, single
    direction: ``BCE(D(x_f) - E[D(x_r)], 1)``, real logits detached."""
    real_mean = _batch_mean(real_logits.detach())
    return _bce_with_logits(fake_logits - real_mean, 1.0)


def ragan_generator_loss_two_sided(real_logits: torch.Tensor,
                                   fake_logits: torch.Tensor
                                   ) -> torch.Tensor:
    """The paper's G loss: the average of both directions,
    ``0.5 [BCE(D(x_r) - E[D(x_f)], 0) + BCE(D(x_f) - E[D(x_r)], 1)]``,
    real logits detached."""
    real = real_logits.detach()
    loss_real = _bce_with_logits(real - _batch_mean(fake_logits), 0.0)
    loss_fake = _bce_with_logits(fake_logits - _batch_mean(real), 1.0)
    return 0.5 * (loss_real + loss_fake)


def ragan_discriminator_loss(real_logits: torch.Tensor,
                             fake_logits: torch.Tensor) -> torch.Tensor:
    """D loss: ``0.5 [BCE(pr - E[pf], 1) + BCE(pf - E[pr], 0)]``."""
    loss_real = _bce_with_logits(real_logits - _batch_mean(fake_logits), 1.0)
    loss_fake = _bce_with_logits(fake_logits - _batch_mean(real_logits), 0.0)
    return 0.5 * (loss_real + loss_fake)


def perceptual_loss(vgg: Callable[[torch.Tensor], torch.Tensor],
                    pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 in VGG conv5_4 pre-activation feature space; the target's
    features are detached."""
    return l1_loss(vgg(pred), vgg(target).detach())


def feature_matching_loss(feats_pred: Sequence[torch.Tensor],
                          feats_target: Sequence[torch.Tensor]
                          ) -> torch.Tensor:
    """Discriminator-feature-matching perceptual term: mean per-scale L1
    between D's activations on SR and HR, targets detached, each scale
    divided by its detached mean |activation| (+ 1e-6)."""
    total = 0.0
    for fp, ft in zip(feats_pred, feats_target):
        ft = ft.detach()
        total = total + l1_loss(fp, ft) / (global_mean(ft.abs().mean())
                                           + 1e-6)
    return total / len(feats_pred)
