"""GAN / pretrain train-step throughput: the port of the JAX package's
``tools/train_bench.py`` (BASELINE.json's "GAN train iters/sec").

    python -m super_resolution_tpu_torch.tools.train_bench \\
        [--step gan|pretrain] [--impls lax,pallas_cf] [--batch 16] \\
        [--hr 192] [--steps 30]

Times the whole step (G forward, the D forwards, both gradients and the
two Adam updates for ``gan``; G forward, gradient and Adam for
``pretrain``) on one seeded uint8 batch, under each ``--impls`` entry:
one step that builds the kernels (``compile+first``), then ``--steps``
steps on the host clock, ended by a synchronise.  ``pallas`` and
``pallas_fused`` have no backward and train on ``lax``, saying so, as
``cli train`` does.  A line per impl: it/s, ms/step, HR MP/s, and the
kernel launches of one step by counter; then the launches of the whole
run.  ``--cf9``, ``--bwd_cap``, ``--fwd_carry`` and ``--bwd_carry`` tune
TPU mechanisms and are refused.
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
    host_sync,
    launch_counters,
    read_launches,
    refuse,
    reset_launches,
)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="train_bench")
    ap.add_argument("--step", default="gan", choices=("gan", "pretrain"))
    ap.add_argument("--impls", default="lax,pallas_cf")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hr", type=int, default=192)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--tail_up", default="naive",
                    choices=("polyphase", "naive"))
    ap.add_argument("--dedup", action="store_true",
                    help="cfg.dedup_d_hr: one D(hr) forward per GAN step")
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
    from super_resolution_tpu_torch.device import resolve_device
    from super_resolution_tpu_torch.train.state import init_state
    from super_resolution_tpu_torch.train.steps import (
        make_gan_step,
        make_pretrain_step,
        training_cfg,
    )

    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    batch = torch.from_numpy(rng.randint(
        0, 256, (args.batch, args.hr, args.hr, 3), dtype=np.uint8)
    ).to(device)
    counters = launch_counters()
    reset_launches(counters)

    for impl in args.impls.split(","):
        cfg = dataclasses.replace(
            preset("train_gan" if args.step == "gan" else "pretrain_psnr"),
            generator=GeneratorConfig(conv_impl=impl, tail_up=args.tail_up),
            data=DataConfig(hr_patch=args.hr, batch_size=args.batch),
            loss=LossConfig(perceptual_source="d_features",
                            lambda_percep=1.0),
            warmup_batches=0,
            dedup_d_hr=args.dedup,
        )
        make_step = (make_gan_step if args.step == "gan"
                     else make_pretrain_step)
        try:
            cfg = training_cfg(cfg)
            state = init_state(cfg, device)
            step = make_step(cfg)
            t0 = time.perf_counter()
            step(state, batch)
            host_sync(device)
            print(f"{impl:10s} compile+first: "
                  f"{time.perf_counter() - t0:.0f}s", flush=True)
            before = read_launches(counters)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step(state, batch)
            host_sync(device)
            dt = (time.perf_counter() - t0) / args.steps
            per_step = {n: (v - before[n]) // args.steps
                        for n, v in read_launches(counters).items()
                        if v != before[n]}
            mp = args.batch * args.hr * args.hr / 1e6
            print(f"{impl:10s} {args.step}: {1.0 / dt:6.2f} it/s  "
                  f"({dt * 1e3:.1f} ms/step, {mp / dt:.2f} MP/s HR, "
                  f"batch {args.batch}x{args.hr}²)  launches/step "
                  f"{json.dumps(per_step)}", flush=True)
        except Exception as e:                  # noqa: BLE001 (the JAX tool's)
            print(f"{impl:10s} FAILED {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
    print("launches: " + json.dumps(read_launches(counters)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
