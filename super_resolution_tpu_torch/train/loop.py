"""Training orchestration (the JAX package's ``train/loop.py``): warmup
L1 pretrain -> alternating GAN steps, periodic sampling and
checkpointing, in-loop eval, metrics, resume.

The warmup/GAN switch is host-side control flow over the two steps.

Under data parallelism :func:`train` runs once per rank, inside the
process group that :func:`parallel.dp.launch` or
:func:`parallel.multihost.launch` brings up (``cli train
--data_parallel N [--multihost ...]``), with ``cfg.data_parallel``
equal to the group's size.  Each rank loads its rows of the global
batch (``part=(rank, world)``), starts from rank 0's parameters and
statistics (broadcast after init, warm start and resume), and steps
with global-batch semantics (``train/steps.py``), so the ranks stay
equal.  Rank 0 alone writes the logs, sample grids, in-loop eval and
checkpoints, each save followed by a barrier; every rank resumes from
the step directory rank 0 names.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Union

import numpy as np
import torch

from super_resolution_tpu_torch.checkpoint import (
    latest_step,
    read_ema_provenance,
    restore_checkpoint,
    restore_generator_params,
    save_checkpoint,
    write_ema_provenance,
)
from super_resolution_tpu_torch.config import TrainConfig
from super_resolution_tpu_torch.data import (
    PatchLoader,
    SyntheticPatches,
    device_prefetch,
    preprocess_batch,
    to_uint8_image,
)
from super_resolution_tpu_torch.device import resolve_device
from super_resolution_tpu_torch.metrics import (
    MetricLogger,
    Throughput,
    span,
)
from super_resolution_tpu_torch.ops.resize import bicubic_resize
from super_resolution_tpu_torch.parallel import dp, multihost
from super_resolution_tpu_torch.train.state import (
    GANTrainState,
    eval_params,
    init_state,
    set_generator_params,
)
from super_resolution_tpu_torch.train.steps import (
    make_gan_step,
    make_infer_fn,
    make_pretrain_step,
    training_cfg,
)


def _save_sample_grid(cfg: TrainConfig, state: GANTrainState, batch,
                      step: int, out_dir: str, logger=None,
                      ema_warm: bool = False):
    """Periodic sample dump: rows = bicubic x4 baseline | SR | HR, one
    column per sample (the first four of ``batch``, on the device)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    paired = isinstance(batch, dict)
    head = {k: v[:4] for k, v in batch.items()} if paired else batch[:4]
    hr_u8 = head["hr"] if paired else head
    pair = preprocess_batch(head, cfg.data, augment=False)
    infer = make_infer_fn(cfg, eval_params(cfg, state, warm_start=ema_warm),
                          hr_u8.device)
    sr_u8 = to_uint8_image(infer(pair["lr"]), cfg.data)
    h, w = hr_u8.shape[1:3]
    if paired:
        # the baseline row upsamples the real paired LR the model saw
        bic = bicubic_resize(head["lr"].float() / 255.0, h, w)
    else:
        bic = bicubic_resize(
            bicubic_resize(hr_u8.float() / 255.0, h // cfg.data.scale,
                           w // cfg.data.scale), h, w)
    bic_u8 = torch.clamp(torch.round(bic * 255), 0, 255).to(torch.uint8)
    rows = [np.concatenate(list(imgs.cpu().numpy()), axis=1)
            for imgs in (bic_u8, sr_u8, hr_u8)]
    grid = np.concatenate(rows, axis=0)
    Image.fromarray(grid).save(os.path.join(out_dir, f"step{step:08d}.png"))
    if logger is not None:
        logger.log_image(step, "samples/bicubic_sr_hr", grid)


def _warm_start(cfg: TrainConfig, state: GANTrainState, init_g_from: str):
    """Warm-start G from a PSNR-pretrain checkpoint (a torch ``.pth`` or a
    checkpoint directory of this package) into a fresh GAN state.
    Optimizers, D and the generators start fresh; only G's parameters
    are replaced, and the EMA is seeded from them."""
    if os.path.isfile(init_g_from):
        from super_resolution_tpu_torch.import_torch import (
            import_generator,
            load_pth,
        )

        sd, _ = import_generator(load_pth(init_g_from), cfg.generator)
    else:
        # maturity-gated like every other read surface: an immature
        # from-scratch EMA must not seed the fine-tune
        sd, at = restore_generator_params(init_g_from,
                                          ema_decay=cfg.ema_decay)
        print(f"[train] warm-starting G from step-{at} checkpoint")
    set_generator_params(state, sd)
    if state.g_ema is not None and multihost.is_primary():
        # this run's EMA starts from the warm-start weights, not from a
        # random init, so the step-count maturity gate does not apply
        write_ema_provenance(cfg.checkpoint_dir, {
            "warm_start": True, "source": os.path.abspath(init_g_from)})


def train(cfg: TrainConfig,
          data_iter: Optional[Iterator[np.ndarray]] = None,
          data_loader=None,
          total_steps: Optional[int] = None,
          resume: bool = False,
          log_dir: Optional[str] = None,
          sample_dir: Optional[str] = None,
          eval_dir: Optional[str] = None,
          eval_interval: Optional[int] = None,
          init_g_from: Optional[str] = None,
          device: Union[str, torch.device] = "cuda") -> GANTrainState:
    """Run training on ``device``; returns the final state.

    Data comes from (in priority order) ``data_iter`` (a plain iterator of
    uint8 numpy batches, no resume state), ``data_loader`` (any loader
    with ``__iter__``/``state_dict``/``load_state_dict``), or a default
    :class:`PatchLoader` over ``cfg.data.dataset_dir`` (synthetic patches
    if the directory is absent, which keeps smoke runs dataset-free)."""
    if cfg.data_parallel != dp.world_size() and (
            dp.active() or cfg.data_parallel > 1):
        raise ValueError(
            f"data_parallel={cfg.data_parallel} but this process is rank "
            f"{dp.rank()} of {dp.world_size()}: train() runs once per "
            f"rank, inside the process group of parallel.dp.launch (cli "
            f"train --data_parallel N)")
    dp.local_rows(cfg.data.batch_size)     # the global batch must divide
    device = resolve_device(device)
    primary = multihost.is_primary()
    cfg = training_cfg(cfg)
    total_steps = total_steps if total_steps is not None \
        else cfg.n_epochs * cfg.steps_per_epoch

    loader = data_loader
    if data_iter is None and loader is None:
        # each rank loads its rows of the global batch
        part = multihost.data_part()
        if os.path.isdir(cfg.data.dataset_dir):
            loader = PatchLoader(cfg.data, seed=cfg.seed, part=part)
        else:
            print(f"[train] dataset dir {cfg.data.dataset_dir!r} missing — "
                  "using synthetic patches")
            loader = SyntheticPatches(cfg.data, seed=cfg.seed, part=part)

    state = init_state(cfg, device)
    start_step = 0
    if init_g_from and not resume:
        _warm_start(cfg, state, init_g_from)
    if resume:
        # every rank restores the step directory rank 0 sees as newest
        at = [latest_step(cfg.checkpoint_dir) if primary else None]
        if dp.active():
            torch.distributed.broadcast_object_list(at, src=0)
        if at[0] is None:
            print("[train] no checkpoint found; starting fresh")
        else:
            state, data_state, start_step = restore_checkpoint(
                cfg.checkpoint_dir, state, step=at[0])
            if data_state and loader is not None:
                loader.load_state_dict(data_state)
            print(f"[train] resumed from step {start_step}")
    # the ranks start equal: rank 0's parameters, statistics and EMA (the
    # Adam states are equal already: empty, or read from one file)
    dp.broadcast_([*state.g.parameters(), *state.d.parameters(),
                   *state.d.buffers(),
                   *(state.g_ema.values() if state.g_ema else ())])

    # is this run's EMA trusted whatever the step count?  True when it
    # was seeded from warm-start weights: this run's init_g_from, or
    # the recorded provenance of the run being resumed
    ema_warm = bool(init_g_from) or bool(
        (read_ema_provenance(cfg.checkpoint_dir) or {}).get("warm_start"))

    # Track the loader state that belongs to each batch as it is pulled,
    # so a checkpoint stores the state matching the batch the loop
    # consumed: the prefetcher runs ahead by cfg.data.prefetch, and the
    # live loader state would make a resume skip those batches.
    pulled_states: dict = {}
    n_pulled = [0]

    def _tracked(src):
        for b in src:
            n_pulled[0] += 1
            if loader is not None:
                pulled_states[n_pulled[0]] = loader.state_dict()
            yield b

    if data_iter is None:
        data_iter = iter(loader)
    data_iter = device_prefetch(_tracked(data_iter), cfg.data.prefetch,
                                device)

    pretrain_step = make_pretrain_step(cfg)
    gan_step = make_gan_step(cfg) if cfg.loss.lambda_adv > 0 else None

    logger = MetricLogger(log_dir if primary else None, stdout=primary)
    meter = Throughput(n_chips=dp.world_size(), device=device)
    log_every = 50
    n_consumed = 0

    for step_idx in range(start_step, total_steps):
        with span("train.data_wait"):
            batch = next(data_iter)
        n_consumed += 1
        pulled_states.pop(n_consumed - 1, None)   # keep current and ahead
        in_warmup = gan_step is None or step_idx < cfg.warmup_batches
        step_fn = pretrain_step if in_warmup else gan_step
        logger.update(step_fn(state, batch))
        # HR patches count output pixels directly (B*H*W)
        hr_ref = batch["hr"] if isinstance(batch, dict) else batch
        meter.add(int(np.prod(hr_ref.shape[:3])))

        done = step_idx + 1
        if done % log_every == 0 or done == total_steps:
            logger.flush(done, "warmup" if in_warmup else "gan",
                         extra={"mp_per_sec_per_chip":
                                meter.mp_per_sec_per_chip()})
            meter.reset()
        if sample_dir and primary and done % cfg.sample_interval == 0:
            _save_sample_grid(cfg, state, batch, done, sample_dir,
                              logger=logger, ema_warm=ema_warm)
        if eval_dir and primary \
                and done % (eval_interval or cfg.checkpoint_interval) == 0:
            from super_resolution_tpu_torch.train.evaluate import (
                evaluate_directory,
            )

            tile = max(cfg.data.lr_patch, 48)
            infer = make_infer_fn(
                cfg, eval_params(cfg, state, warm_start=ema_warm), device)
            ev = evaluate_directory(cfg, None, eval_dir, tile=tile,
                                    halo=min(8, tile // 4), max_images=8,
                                    infer_fn=infer, device=device)
            logger.log_once(done, "eval",
                            {f"val_{k}": v for k, v in ev.items()})
        if done % cfg.checkpoint_interval == 0 or done == total_steps:
            if primary:
                data_state = pulled_states.get(n_consumed) \
                    if loader is not None else None
                save_checkpoint(cfg.checkpoint_dir, state, data_state)
            dp.barrier()        # no rank runs ahead of a partial save

    logger.close()
    return state
