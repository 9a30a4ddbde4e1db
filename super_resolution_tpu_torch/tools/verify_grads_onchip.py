"""Full-model gradient gate on the card: the port of the JAX package's
``tools/verify_grads_onchip.py``.

A backward can be right on the CPU and wrong on the device: the CPU runs
the kernels' plain versions, the card the kernels.  This gate builds the
canonical 23-block RRDBNet at the training shape, computes the
L1-pretrain gradients of its parameters under ``conv_impl="lax"``
(cuDNN) and ``"pallas_cf"`` (whatever ``train.steps.training_cfg``
routes it to, printed), both states drawn from the same seed, and holds
the two: losses within 1e-4, every kernel gradient finite, and the
worst parameter's ‖kernel − lax‖ / ‖lax‖ within ``--tol`` (bf16 cuDNN
rounds where the kernels keep f32).

    python -m super_resolution_tpu_torch.tools.verify_grads_onchip \\
        [--batch 16] [--hr 192] [--tol 0.02]

Exit code 0 (and ``ON-CHIP GRAD PARITY: OK``) means the gate holds;
then the launches of the run by counter.  ``--cf9``, ``--bwd_cap``,
``--fwd_carry`` and ``--bwd_carry`` tune TPU mechanisms and are
refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from super_resolution_tpu_torch.tools import (
    BWD_CARRY_REFUSED,
    CF9_REFUSED,
    FWD_CARRY_REFUSED,
    LANE_CAP_REFUSED,
    launch_counters,
    read_launches,
    refuse,
    reset_launches,
)

LOSS_TOL = 1e-4


def grads_for(impl, batch_u8, cfg_base, device):
    """(loss, {name: gradient}) of the L1 pretrain loss under ``impl``."""
    from super_resolution_tpu_torch.config import GeneratorConfig
    from super_resolution_tpu_torch.data.augment import preprocess_batch
    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.losses import l1_loss
    from super_resolution_tpu_torch.train.state import init_state
    from super_resolution_tpu_torch.train.steps import training_cfg

    cfg = training_cfg(dataclasses.replace(
        cfg_base, generator=GeneratorConfig(conv_impl=impl)))
    print(f"{impl} -> training impl: {cfg.generator.conv_impl}", flush=True)
    state = init_state(cfg, device)
    names, params = zip(*state.g.named_parameters())
    pair = preprocess_batch(batch_u8, cfg.data, state.aug_rng)
    with no_tf32():
        loss = l1_loss(state.g(pair["lr"]), pair["hr"])
        grads = torch.autograd.grad(loss, params)
    grads = {n: g.detach().float() for n, g in zip(names, grads)}
    gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values())).item()
    loss = loss.item()
    print(f"{impl}: loss={loss:.6f} gnorm={gn:.4g}", flush=True)
    return loss, grads


def main(argv=None):
    ap = argparse.ArgumentParser(prog="verify_grads_onchip")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hr", type=int, default=192)
    ap.add_argument("--tol", type=float, default=0.02,
                    help="max leafwise relative grad diff")
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
    from super_resolution_tpu_torch.config import DataConfig, preset
    from super_resolution_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg_base = dataclasses.replace(
        preset("pretrain_psnr"),
        data=DataConfig(hr_patch=args.hr, batch_size=args.batch))
    rng = np.random.RandomState(0)
    batch_u8 = torch.from_numpy(rng.randint(
        0, 256, (args.batch, args.hr, args.hr, 3), dtype=np.uint8)
    ).to(device)

    counters = launch_counters()
    reset_launches(counters)
    loss_l, gl = grads_for("lax", batch_u8, cfg_base, device)
    loss_k, gk = grads_for("pallas_cf", batch_u8, cfg_base, device)
    launches = read_launches(counters)

    if not abs(loss_l - loss_k) < LOSS_TOL:
        raise SystemExit(f"losses differ: lax {loss_l} vs pallas_cf "
                         f"{loss_k} (limit {LOSS_TOL})")
    worst, worst_path, n_nonfinite = 0.0, None, 0
    for name, al in gl.items():
        ak = gk[name]
        n_nonfinite += int((~torch.isfinite(ak)).sum())
        rd = (torch.linalg.vector_norm(ak - al)
              / (torch.linalg.vector_norm(al) + 1e-12)).item()
        if rd > worst:
            worst, worst_path = rd, name
    print(f"worst leaf reldiff: {worst:.4g} at {worst_path}; "
          f"non-finite kernel grad elements: {n_nonfinite}", flush=True)
    if n_nonfinite:
        raise SystemExit(f"{n_nonfinite} non-finite kernel grad elements")
    if not worst <= args.tol:
        raise SystemExit(f"worst leaf reldiff {worst:.4g} at {worst_path} "
                         f"exceeds --tol {args.tol}")
    print("ON-CHIP GRAD PARITY: OK", flush=True)
    print("launches: " + json.dumps(launches), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
