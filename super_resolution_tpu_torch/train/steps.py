"""Train steps (the JAX package's ``train/steps.py``): the L1 warmup
pretrain step, the alternating G/D GAN step, the inference forward and
the eval batch.

- The warmup branch is host-side control flow: the loop picks
  :func:`make_pretrain_step` or :func:`make_gan_step` by step count.
- One GAN step computes G's gradients, then D's on the detached SR
  (recomputed forwards, as the reference does), then applies both Adam
  updates and the EMA: every gradient is taken before any parameter
  moves, which is what the JAX step's pure function does.
- D's BatchNorm running statistics update on the D step's two forwards
  (hr, then detached sr); ``cfg.bn_track_g_step`` also updates them on
  the G step's two, in the reference's order (hr, sr, hr, detached sr).
- Each step is ``step(state, uint8 batch) -> metrics`` and mutates the
  state in place; ``step.core(state, lr, hr)`` is the same step from an
  already normalised pair.  Metrics are 0-dim tensors on the device (no
  synchronisation here).  After a step every parameter's ``.grad`` holds
  the gradient that was applied.
- While recording (:mod:`metrics`) a step is the span
  ``train.gan_step`` (``train.pretrain_step``) with one child span per
  phase: ``train.prep``, ``train.g_forward``, ``train.d_real``,
  ``train.g_loss`` (child ``train.vgg``), ``train.g_backward``,
  ``train.d_grads``, ``train.grad_allreduce`` (both models' gradients,
  after both are taken), ``train.adam_g``, ``train.adam_d``,
  ``train.ema`` and ``train.step_metrics``, each where it applies.
- Global-batch semantics, as in the JAX package: under data
  parallelism (:mod:`parallel.dp`) a rank's batch is its rows of the
  global batch, the RaGAN batch means and D's batch statistics are the
  global batch's (``losses``, ``models.discriminator``), each model's
  gradients are averaged over the ranks between ``autograd.grad`` and
  the update, and the metrics are the global values (losses averaged,
  PSNR of the global MSE, gradient norms of the averaged gradients).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from super_resolution_tpu_torch.config import (
    SwinIRConfig,
    TrainConfig,
    resolve_conv_impl,
)
from super_resolution_tpu_torch.data.augment import (
    denormalize,
    preprocess_batch,
)
from super_resolution_tpu_torch.device import no_tf32, resolve_device
from super_resolution_tpu_torch.metrics import span
from super_resolution_tpu_torch.losses import (
    feature_matching_loss,
    l1_loss,
    mse,
    perceptual_loss,
    psnr,
    psnr_of_mse,
    ragan_discriminator_loss,
    ragan_generator_loss,
    ragan_generator_loss_two_sided,
)
from super_resolution_tpu_torch.models.rrdb import RRDBNet
from super_resolution_tpu_torch.parallel.dp import (
    average_gradients,
    average_metrics,
)
from super_resolution_tpu_torch.parallel.multihost import data_part
from super_resolution_tpu_torch.train.state import (
    GANTrainState,
    apply_update,
    compute_dtype,
    ema_update,
    lr_schedule,
)

Metrics = Dict[str, torch.Tensor]
StepFn = Callable[[GANTrainState, torch.Tensor], Metrics]


def training_cfg(cfg: TrainConfig) -> TrainConfig:
    """The config training differentiates through, after the JAX
    package's ``train/steps.py:_training_cfg``: ``auto`` resolved to
    ``pallas_cf``; ``lax``, ``pallas_cf`` and ``pallas_cf_tail`` train as
    they are (the kernels take every geometry, so nothing falls back);
    ``pallas`` and ``pallas_fused`` have no backward and train on
    ``lax``, as in the JAX package, saying so in one line.  The
    parameters are the same under every impl, so checkpoints swap
    freely."""
    impl = resolve_conv_impl(cfg.generator.conv_impl)
    if impl in ("pallas", "pallas_fused"):
        print(f"[train] conv_impl={impl!r} has no backward: training on "
              f"'lax' (the same parameters)", flush=True)
        impl = "lax"
    return dataclasses.replace(
        cfg, generator=dataclasses.replace(cfg.generator, conv_impl=impl))


def _mse01(cfg: TrainConfig, sr: torch.Tensor, hr: torch.Tensor):
    """MSE in [0, 1] image space (denormalised and clipped), whose PSNR
    the training log reports, so that it compares with eval PSNR."""
    mean, std = cfg.data.normalize_mean, cfg.data.normalize_std
    sr01 = denormalize(sr, mean, std).clamp(0.0, 1.0)
    return mse(sr01, denormalize(hr, mean, std))


def _global_metrics(local: Metrics, **norms) -> Metrics:
    """The step's metrics over the global batch: the per-rank means
    averaged over the ranks, PSNR from the global MSE (the ``mse01``
    entry), the gradient norms as given (of the averaged gradients)."""
    out = average_metrics(local)
    out["psnr"] = psnr_of_mse(out.pop("mse01"))
    out.update(norms)
    return out


def global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(grads))))


def _with_prep(cfg: TrainConfig, core, name: str) -> StepFn:
    def full_f32(state: GANTrainState, lr, hr) -> Metrics:
        # float32 convolutions stay float32 in the backward too (the
        # models switch TF32 off only around their forwards)
        with no_tf32():
            return core(state, lr, hr)

    def step(state: GANTrainState, batch_uint8) -> Metrics:
        with span(name):
            with span("train.prep"):
                batch = preprocess_batch(batch_uint8, cfg.data,
                                         state.aug_rng, part=data_part())
            return full_f32(state, batch["lr"], batch["hr"])

    step.core = full_f32
    return step


def make_pretrain_step(cfg: TrainConfig) -> StepFn:
    """PSNR-only L1 pretraining of G (the warmup branch)."""
    sched_g = lr_schedule(cfg.optim_g)

    def core(state: GANTrainState, lr, hr) -> Metrics:
        g_params = list(state.g.parameters())
        with span("train.g_forward"):
            sr = state.g(lr)
        with span("train.g_loss"):
            pix = l1_loss(sr, hr)
        with span("train.g_backward"):
            grads = torch.autograd.grad(pix, g_params)
        with span("train.grad_allreduce"):
            grads = average_gradients(grads)
        with span("train.adam_g"):
            apply_update(state.g_opt, sched_g, grads)
        with span("train.ema"):
            ema_update(cfg, state.g_ema, state.g)
        state.step += 1
        with span("train.step_metrics"):
            return _global_metrics(
                {"loss_pixel": pix.detach(),
                 "mse01": _mse01(cfg, sr.detach(), hr)},
                grad_norm_g=global_norm(grads))

    return _with_prep(cfg, core, "train.pretrain_step")


def make_gan_step(cfg: TrainConfig) -> StepFn:
    """Full ESRGAN alternating G/D step.  ``cfg.dedup_d_hr`` (without
    ``bn_track_g_step``) computes the D(hr) forward once instead of
    twice: its value and feature maps feed the G loss, its gradient the
    D update — the same updates from three discriminator forwards."""
    lcfg = cfg.loss
    sched_g, sched_d = lr_schedule(cfg.optim_g), lr_schedule(cfg.optim_d)
    dfm = lcfg.use_perceptual and lcfg.perceptual_source == "d_features"
    dedup = cfg.dedup_d_hr and not cfg.bn_track_g_step
    g_adv_fn = (ragan_generator_loss_two_sided if lcfg.ragan_g_two_sided
                else ragan_generator_loss)

    def g_loss(state, sr, hr, pr, fr, track):
        """G's losses as a function of sr; pr, fr are D(hr)'s logits and
        features, detached."""
        pix = l1_loss(sr, hr)
        pf, ff = state.d(sr, train=True, return_features=True,
                         update_stats=track)
        adv = g_adv_fn(pr, pf)
        parts = {"loss_pixel": pix, "loss_adv": adv}
        total = lcfg.lambda_adv * adv + lcfg.lambda_pixel * pix
        if state.vgg is not None:
            with span("train.vgg"):
                parts["loss_percep"] = perceptual_loss(state.vgg, sr, hr)
        elif dfm:
            parts["loss_percep"] = feature_matching_loss(ff, fr)
        if "loss_percep" in parts:
            total = total + lcfg.lambda_percep * parts["loss_percep"]
        parts["loss_g"] = total
        return total, parts

    def core(state: GANTrainState, lr, hr) -> Metrics:
        g_params = list(state.g.parameters())
        d_params = list(state.d.parameters())
        track = cfg.bn_track_g_step
        with span("train.g_forward"):
            sr = state.g(lr)
        sr_detached = sr.detach()

        if dedup:
            # D's gradients first, from the parameters and statistics the
            # reference's D step reads; its D(hr) forward also gives the
            # G loss its real logits and features
            with span("train.d_real"):
                pr, fr = state.d(hr, train=True, return_features=True)
            with span("train.d_grads"):
                pf_bar = state.d(sr_detached, train=True)
                d_loss = ragan_discriminator_loss(pr, pf_bar)
                d_grads = torch.autograd.grad(d_loss, d_params)
            with span("train.g_loss"):
                sr_in = sr_detached.clone().requires_grad_(True)
                total, parts = g_loss(state, sr_in, hr, pr.detach(),
                                      [f.detach() for f in fr], False)
            with span("train.g_backward"):
                (dsr,) = torch.autograd.grad(total, sr_in)
                g_grads = torch.autograd.grad(sr, g_params, dsr)
        else:
            # G's gradients: nothing of D(hr) carries a gradient to G
            with span("train.d_real"), torch.no_grad():
                pr, fr = state.d(hr, train=True, return_features=True,
                                 update_stats=track)
            with span("train.g_loss"):
                total, parts = g_loss(state, sr, hr, pr, fr, track)
            with span("train.g_backward"):
                g_grads = torch.autograd.grad(total, g_params)
            # D's gradients on recomputed forwards, SR detached
            with span("train.d_grads"):
                pr = state.d(hr, train=True)
                pf_bar = state.d(sr_detached, train=True)
                d_loss = ragan_discriminator_loss(pr, pf_bar)
                d_grads = torch.autograd.grad(d_loss, d_params)
        with span("train.grad_allreduce"):
            d_grads = average_gradients(d_grads)
            g_grads = average_gradients(g_grads)

        with span("train.adam_g"):
            apply_update(state.g_opt, sched_g, g_grads)
        with span("train.adam_d"):
            apply_update(state.d_opt, sched_d, d_grads)
        with span("train.ema"):
            ema_update(cfg, state.g_ema, state.g)
        state.step += 1
        with span("train.step_metrics"):
            metrics = {k: v.detach() for k, v in parts.items()}
            metrics.update({"loss_d": d_loss.detach(),
                            "mse01": _mse01(cfg, sr_detached, hr)})
            return _global_metrics(metrics,
                                   grad_norm_g=global_norm(g_grads),
                                   grad_norm_d=global_norm(d_grads))

    return _with_prep(cfg, core, "train.gan_step")


def make_infer_fn(cfg: TrainConfig, state_dict: Dict[str, torch.Tensor],
                  device: str | torch.device = "cuda"
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Normalised NHWC LR → normalised NHWC SR forward of the generator
    that ``cfg.generator`` names (RRDBNet, or SwinIR for a
    :class:`config.SwinIRConfig`) with ``state_dict`` (the port's float32
    names, loaded strictly), built on ``device`` and cast to
    ``cfg.compute_dtype`` once, here."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg)
    if isinstance(cfg.generator, SwinIRConfig):
        from super_resolution_tpu_torch.models.swinir import SwinIR

        model = SwinIR(cfg.generator)
    else:
        model = RRDBNet(cfg.generator)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(device).eval().prepare(dtype)

    def infer(lr: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(lr)

    return infer


def eval_batch(cfg: TrainConfig, g_state_dict: Dict[str, torch.Tensor],
               hr_uint8, device: str | torch.device = "cuda") -> Metrics:
    """Deterministic eval of a uint8 batch, as the JAX package's
    ``eval_batch``: no augmentation, LR bicubic-synthesised from the HR
    batch (or a paired ``{"hr", "lr"}`` dict), the generator of
    :func:`make_infer_fn` under ``cfg.generator.conv_impl`` and
    ``cfg.compute_dtype``, and the PSNR of the SR image, denormalised and
    clipped to [0, 1], against the HR image.  ``hr_uint8`` (tensors or
    numpy arrays) moves to ``device``."""
    device = resolve_device(device)
    if isinstance(hr_uint8, dict):
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in hr_uint8.items()}
    else:
        batch = torch.as_tensor(hr_uint8).to(device)
    batch = preprocess_batch(batch, cfg.data, augment=False)
    sr = make_infer_fn(cfg, g_state_dict, device)(batch["lr"])
    mean, std = cfg.data.normalize_mean, cfg.data.normalize_std
    sr01 = denormalize(sr, mean, std).clamp(0.0, 1.0)
    return {"psnr": psnr(sr01, denormalize(batch["hr"], mean, std))}
