"""The GAN train step split into its parts: the port of the JAX package's
``tools/profile_gan.py``.

    python -m super_resolution_tpu_torch.tools.profile_gan [--batch 16] \\
        [--hr 192] [--impl lax|pallas_cf] [--trace DIR]

The ``train_gan`` preset with the D-feature perceptual loss, the
canonical 23-block generator, seeded inputs.  The component table:
preprocessing (augmentation, bicubic /4, normalisation), G forward, G
forward + backward of an L2 loss, the same for a stem+tail-only
generator (no blocks) and the trunk by difference, D forward in train
mode, the G step's D pass (two D forwards and the gradient with respect
to the SR input), the D step (two forwards and D's parameter gradients),
and the two Adam updates.  Each component: ms per call from CUDA events
over ``ITERS`` calls after a warm-up, and beside it the device time per
call from ``torch.profiler`` (kernels and copies only).  The step is
host-bound, so where the host enqueues more slowly than the card runs,
the first number is the host's and the second the card's.  D's running
statistics are not updated by the components (the JAX tool throws its
``batch_stats`` away).  Then the full GAN step (host clock around
``FULL_STEPS`` steps, synchronised) with its launches per step, and the
sum of the components.  Then the same steps with the program's spans
recording (:func:`metrics.recording`, no profiler): the step's ms with
recording on beside off (the recording's cost; ``ON_OFF_PAIRS`` runs of
each in turns, medians), and the phase table of the last run
from :func:`metrics.span_report`, each span's calls, host ms per step
and share of ``train.gan_step`` (device ms per step for the device
spans), and the cost of one span call, off, recording, recording with
timing events on the card, and under a profiler.  ``--trace DIR``
writes a ``torch.profiler`` trace of ``--trace_steps`` full steps, and
their spans (``<host>_<pid>.spans.json``), into DIR.  ``--cf9``,
``--bwd_cap``, ``--fwd_carry`` and ``--bwd_carry`` tune TPU mechanisms
and are refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from super_resolution_tpu_torch.tools import (
    BWD_CARRY_REFUSED,
    CF9_REFUSED,
    FWD_CARRY_REFUSED,
    LANE_CAP_REFUSED,
    device_ms,
    host_sync,
    launch_counters,
    read_launches,
    refuse,
    reset_launches,
    time_ms,
)

ITERS = 20
FULL_STEPS = 20
ON_OFF_PAIRS = 3
SPAN_CALLS = 20000


def span_cost_us(device: torch.device, calls: int = SPAN_CALLS):
    """Host µs per ``with span(...)`` call: recording off, recording,
    recording with timing events (on the card), under a profiler."""
    from torch.profiler import ProfilerActivity, profile

    from super_resolution_tpu_torch.metrics import recording, span

    def per_call(dev):
        t0 = time.perf_counter()
        for _ in range(calls):
            with span("profile_gan.cost", dev):
                pass
        return (time.perf_counter() - t0) / calls * 1e6

    out = {"off": per_call(False)}
    with recording():
        out["on"] = per_call(False)
        if device.type == "cuda":
            out["on_device"] = per_call(device)
            torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU]):
        out["profiler"] = per_call(False)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="profile_gan")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hr", type=int, default=192)
    ap.add_argument("--impl", default="lax")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--trace_steps", type=int, default=10)
    ap.add_argument("--cf9", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="refused: the v9 routing is a TPU layout choice")
    ap.add_argument("--bwd_cap", type=int, default=None,
                    help="refused: the Pallas backward's lane cap")
    ap.add_argument("--fwd_carry", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="refused: the fused forward's halo carry")
    ap.add_argument("--bwd_carry", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="refused: the Pallas backward's halo carry")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    refuse(args, cf9=CF9_REFUSED, bwd_cap=LANE_CAP_REFUSED,
           fwd_carry=FWD_CARRY_REFUSED, bwd_carry=BWD_CARRY_REFUSED)

    from super_resolution_tpu_torch.config import (
        DataConfig,
        GeneratorConfig,
        LossConfig,
        preset,
    )
    from super_resolution_tpu_torch.data.augment import preprocess_batch
    from super_resolution_tpu_torch.device import no_tf32, resolve_device
    from super_resolution_tpu_torch.losses import (
        feature_matching_loss,
        ragan_discriminator_loss,
        ragan_generator_loss,
    )
    from super_resolution_tpu_torch.metrics import (
        profiler_trace,
        recording,
        span_report,
    )
    from super_resolution_tpu_torch.models.rrdb import RRDBNet
    from super_resolution_tpu_torch.train.state import (
        apply_update,
        compute_dtype,
        init_state,
        lr_schedule,
        make_optimizer,
    )
    from super_resolution_tpu_torch.train.steps import (
        make_gan_step,
        training_cfg,
    )

    device = resolve_device(args.device)
    cfg = training_cfg(dataclasses.replace(
        preset("train_gan"),
        generator=GeneratorConfig(conv_impl=args.impl),
        data=DataConfig(hr_patch=args.hr, batch_size=args.batch),
        loss=LossConfig(perceptual_source="d_features",
                        lambda_percep=1.0),
        warmup_batches=0,
    ))
    lr_hw = args.hr // 4
    rng = np.random.RandomState(0)
    hr_u8 = torch.from_numpy(rng.randint(
        0, 256, (args.batch, args.hr, args.hr, 3), dtype=np.uint8)
    ).to(device)
    lr = torch.from_numpy(rng.randn(args.batch, lr_hw, lr_hw, 3)
                          .astype(np.float32)).to(device)
    hr = torch.from_numpy(rng.randn(args.batch, args.hr, args.hr, 3)
                          .astype(np.float32)).to(device)

    state = init_state(cfg, device)
    g, d = state.g, state.d
    g0 = RRDBNet(dataclasses.replace(cfg.generator, n_blocks=0),
                 torch.Generator().manual_seed(0)).to(device)
    g0.prepare(compute_dtype(cfg), live=True)
    gp, g0p, dp = (list(m.parameters()) for m in (g, g0, d))
    aug = torch.Generator().manual_seed(0)

    rows = []

    def add(name, fn=None, t=None, dev=None):
        if fn is not None:
            t, dev = time_ms(fn, device, ITERS), device_ms(fn, device)
        rows.append((name, t, dev))
        dev_s = "not measured" if dev is None else f"{dev:8.2f} ms"
        print(f"{name:34s} {t:8.2f} ms  device {dev_s}", flush=True)
        return t, dev

    def g_l2_grad(net, params):
        def fn():
            with no_tf32():
                loss = torch.sum((net(lr).float() - hr) ** 2)
                return torch.autograd.grad(loss, params)
        return fn

    def g_side_d():
        # the G step's D pass: D(hr) without a gradient, as the step has
        # it; the adversarial and feature-matching terms' gradient with
        # respect to the SR input, D's parameters frozen
        with no_tf32():
            sr = hr.clone().requires_grad_(True)
            with torch.no_grad():
                pr, fr = d(hr, train=True, return_features=True,
                           update_stats=False)
            pf, ff = d(sr, train=True, return_features=True,
                       update_stats=False)
            loss = (5e-3 * ragan_generator_loss(pr, pf)
                    + feature_matching_loss(ff, fr))
            return torch.autograd.grad(loss, sr)

    def d_step():
        with no_tf32():
            pr = d(hr, train=True, update_stats=False)
            pf = d(hr, train=True, update_stats=False)
            return torch.autograd.grad(ragan_discriminator_loss(pr, pf), dp)

    def adam(params, ocfg):
        # zero gradients: Adam's arithmetic over the tree, the
        # parameters unchanged
        opt, sched = make_optimizer(ocfg, params), lr_schedule(ocfg)
        zeros = [torch.zeros_like(p) for p in params]
        return lambda: apply_update(opt, sched, zeros)

    with torch.no_grad():
        add("preprocess (aug+bicubic+norm)",
            lambda: preprocess_batch(hr_u8, cfg.data, aug))
        add("G fwd", lambda: g(lr))
    t_full, d_full = add("G fwd+bwd (L2)", g_l2_grad(g, gp))
    t_tail, d_tail = add("  stem+tail-only fwd+bwd", g_l2_grad(g0, g0p))
    add("  => 23-block trunk fwd+bwd", t=t_full - t_tail,
        dev=None if d_full is None or d_tail is None else d_full - d_tail)
    with torch.no_grad():
        add("D fwd (train mode)",
            lambda: d(hr, train=True, update_stats=False))
    add("G-step D pass (2 fwd + d/d_sr bwd)", g_side_d)
    add("D step (2 fwd + param bwd)", d_step)
    add("Adam update (G tree)", adam(gp, cfg.optim_g))
    add("Adam update (D tree)", adam(dp, cfg.optim_d))

    counters = launch_counters()
    step = make_gan_step(cfg)
    step(state, hr_u8)
    host_sync(device)
    reset_launches(counters)
    t0 = time.perf_counter()
    for _ in range(FULL_STEPS):
        step(state, hr_u8)
    host_sync(device)
    t_step = (time.perf_counter() - t0) / FULL_STEPS
    per_step = {n: v // FULL_STEPS
                for n, v in read_launches(counters).items() if v}
    print(f"{'FULL GAN step':34s} {t_step * 1e3:8.2f} ms "
          f"({1 / t_step:.2f} it/s)  launches/step {json.dumps(per_step)}",
          flush=True)
    acc = sum(t for name, t, _ in rows if not name.startswith(" "))
    print(f"{'sum of components':34s} {acc:8.2f} ms", flush=True)

    def steps_s() -> float:
        t0 = time.perf_counter()
        for _ in range(FULL_STEPS):
            step(state, hr_u8)
        host_sync(device)
        return (time.perf_counter() - t0) / FULL_STEPS

    # recording off and on in turns: the host's speed drifts
    off, on = [], []
    for _ in range(ON_OFF_PAIRS):
        off.append(steps_s())
        with recording():
            on.append(steps_s())
            spans = span_report()["spans"]      # the last run's
    t_off, t_on = float(np.median(off)), float(np.median(on))
    print(f"{'FULL GAN step, spans recording':34s} {t_on * 1e3:8.2f} ms "
          f"(off {t_off * 1e3:.2f} ms, on-cost {(t_on - t_off) * 1e3:+.2f} "
          f"ms; medians of {ON_OFF_PAIRS} runs each in turns)", flush=True)
    whole = spans["train.gan_step"]["host_s"]
    print("phase table (spans, per step; share of train.gan_step):")
    for name in ["train.gan_step", *(n for n in spans
                                     if n != "train.gan_step")]:
        s = spans[name]
        dev = s.get("device_s")
        dev_s = "" if dev is None else \
            f"  device {dev / FULL_STEPS * 1e3:8.2f} ms"
        print(f"  {name:28s} {s['calls'] / FULL_STEPS:6.1f} calls "
              f"{s['host_s'] / FULL_STEPS * 1e3:8.2f} ms "
              f"{100 * s['host_s'] / whole:6.1f} %{dev_s}", flush=True)
    cost = span_cost_us(device)
    print("span cost per call: " + "  ".join(
        f"{k} {v:.3f} us" for k, v in cost.items()), flush=True)

    if args.trace:
        with profiler_trace(args.trace):
            for _ in range(args.trace_steps):
                step(state, hr_u8)
            host_sync(device)
        print(f"trace written to {args.trace}", flush=True)
    print("launches: " + json.dumps(read_launches(counters)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
