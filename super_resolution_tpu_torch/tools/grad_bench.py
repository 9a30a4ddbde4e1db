"""Forward + backward of one dense block at the training geometry: the
port of the JAX package's ``tools/grad_bench.py``.

    python -m super_resolution_tpu_torch.tools.grad_bench [--batch 16] \\
        [--h 48] [--w 48] [--variants lax,kernel,kernel_fold]

A (batch, 64, h, w) bf16 block of growth 32 with the JAX tool's seeded
inputs (numpy ``RandomState(0)``: x, an f32 target, weights and biases
×0.05) and the gradient of an L2 loss against the target with respect to
x, so the cotangent is real (the gradient of a plain sum is a constant
that lets a compiler simplify the backward).  Variants:

- ``lax``: autograd through the per-conv block on cuDNN in bf16
  (``tools.kernel_bench.lax_block``);
- ``kernel``: ``ops.dense_block.dense_block_train``, the forward kernel
  with saved activations and the backward kernels;
- ``kernel_fold``: batch-to-lane folding is a TPU layout and is not
  ported; one line says so.

A line per variant: ms per forward + backward (CUDA events over
``ITERS`` calls after a warm-up), TF/s from 3 × the forward's 2·MACs,
and dx's largest difference from ``lax``'s beside the largest |dx|; then
the launches of the whole run by counter.  ``--rows``, ``--bwd_cap`` and
``--bwd_carry`` tune the Pallas kernels' bands and are refused.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from super_resolution_tpu_torch.device import resolve_device
from super_resolution_tpu_torch.ops.dense_block import dense_block_train
from super_resolution_tpu_torch.ops.experiments_dense_block import _packed
from super_resolution_tpu_torch.tools import (
    BWD_CARRY_REFUSED,
    LANE_CAP_REFUSED,
    ROWS_REFUSED,
    launch_counters,
    read_launches,
    refuse,
    reset_launches,
    time_ms,
)
from super_resolution_tpu_torch.tools.kernel_bench import lax_block

ITERS = 20
C, G = 64, 32


def make_inputs(B: int, H: int, W: int, device: torch.device):
    """(x bf16, target f32, HWIO bf16 weights, f32 biases): the JAX
    tool's seeded block."""
    bf16 = torch.bfloat16
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32)) \
        .to(device, bf16)
    tgt = torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32)) \
        .to(device)
    ws, bs = [], []
    cin = C
    for k in range(5):
        co = C if k == 4 else G
        ws.append(torch.from_numpy(rng.randn(3, 3, cin, co)
                                   .astype(np.float32) * 0.05).to(device,
                                                                  bf16))
        bs.append(torch.from_numpy(rng.randn(co).astype(np.float32)
                                   * 0.05).to(device))
        if k < 4:
            cin += co
    return x, tgt, ws, bs


def dx_of(block, x, tgt):
    """d/dx of the L2 loss of ``block(x)`` against ``tgt``."""
    a = x.detach().requires_grad_(True)
    loss = torch.sum((block(a).float() - tgt) ** 2)
    return torch.autograd.grad(loss, a)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="grad_bench")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--h", type=int, default=48)
    ap.add_argument("--w", type=int, default=48)
    ap.add_argument("--variants", default="lax,kernel,kernel_fold")
    ap.add_argument("--rows", type=int, default=0,
                    help="refused unless 0: the Pallas band height")
    ap.add_argument("--bwd_cap", type=int, default=None,
                    help="refused: the Pallas backward's lane cap")
    ap.add_argument("--bwd_carry", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="refused: the Pallas backward's halo carry")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    refuse(args, rows=ROWS_REFUSED, bwd_cap=LANE_CAP_REFUSED,
           bwd_carry=BWD_CARRY_REFUSED)
    device = resolve_device(args.device)

    B, H, W = args.batch, args.h, args.w
    x, tgt, ws, bs = make_inputs(B, H, W, device)
    # forward 2·MACs; the backward about twice that
    flops = 3 * 2 * B * H * W * sum(9 * w.shape[2] * w.shape[3] for w in ws)
    wp, bp = _packed(x, ws, bs)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {card}; block ({B}, {C}, {H}, {W}) bf16, growth {G}, "
          f"fwd+bwd", flush=True)

    blocks = {
        "lax": lambda a: lax_block(a, ws, bs),
        "kernel": lambda a: dense_block_train(a, wp, bp, res_scale=0.2,
                                              slope=0.2),
    }
    counters = launch_counters()
    reset_launches(counters)
    grads = {}
    for name in args.variants.split(","):
        if name == "kernel_fold":
            print(f"{name:12s}: batch-to-lane folding is a TPU layout, "
                  f"not ported (ROADMAP.md)", flush=True)
            continue
        if name not in blocks:
            raise SystemExit(f"unknown variant {name}")
        block = blocks[name]

        def dx():
            return dx_of(block, x, tgt)

        try:
            t = time_ms(dx, device, ITERS)
            grads[name] = dx().float()
            err = ""
            if "lax" in grads and name != "lax":
                d = (grads[name] - grads["lax"]).abs().max().item()
                big = grads["lax"].abs().max().item()
                err = f"  dx maxerr vs lax {d:.2e} of max |dx| {big:.2e}"
            print(f"{name:12s}: {t:7.3f} ms  "
                  f"{flops / (t * 1e-3) / 1e12:6.1f} TF/s (fwd+bwd){err}",
                  flush=True)
        except Exception as e:                  # noqa: BLE001 (the JAX tool's)
            print(f"{name:12s}: FAILED {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
    print("launches: " + json.dumps(read_launches(counters)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
