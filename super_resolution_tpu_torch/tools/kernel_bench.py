"""Microbenchmark of the dense-block kernel variants, one block at a
time: the port of the JAX package's ``tools/kernel_bench.py``.

    python -m super_resolution_tpu_torch.tools.kernel_bench \\
        [--rows 16,32] [--batch 8] [--hw 128] [--variants lax,v3b,v4,v5]

A (batch, 64, hw, hw) bf16 block of growth 32 with the JAX tool's seeded
inputs (numpy ``RandomState(0)``, weights ×0.05).  ``lax`` is the
per-conv block through cuDNN (bias added in bf16, LeakyReLU, concat and
residual in bf16) and the reference of every ``maxerr``; ``v3b``, ``v4``,
``v5``, ``v6``, ``v8`` and ``v9`` (and ``v3``, which the JAX tool left
out: it did not compile on its TPU) run once per band height that
divides ``hw``.  A line per run: ms per call (CUDA events after a warm-up),
TF/s (TOP/s for the int8 ``v8``) from the block's 2·MACs, maxerr
against ``lax``, the launches of one call; then the launches of the
whole run by counter.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.device import no_tf32, resolve_device
from super_resolution_tpu_torch.tools import (
    FWD_CARRY_REFUSED,
    time_ms,
    variants,
)

ITERS = 30


def lax_block(x, ws, bs):
    """The per-conv block in x's dtype on the channels-last storage: the
    JAX tool's ``lax_block``."""
    h = x.contiguous(memory_format=torch.channels_last)
    feats, out = h, h
    for k, (w, b) in enumerate(zip(ws, bs)):
        out = F.conv2d(feats, w.permute(3, 2, 0, 1), b.to(x.dtype),
                       padding=1)
        if k < 4:
            out = torch.where(out >= 0, out, 0.2 * out)
            feats = torch.cat([feats, out], 1)
    return (h + 0.2 * out).contiguous()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kernel_bench")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--variants", default="lax,v3b,v4,v5")
    ap.add_argument("--rows", default="16,32")
    ap.add_argument("--fwd_carry", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="refused: the TPU kernel's halo carry is not "
                         "ported")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    if args.fwd_carry is not None:
        raise SystemExit(FWD_CARRY_REFUSED)
    device = resolve_device(args.device)

    B, H = args.batch, args.hw
    C, G = 64, 32
    rng = np.random.RandomState(0)
    bf16 = torch.bfloat16
    x = torch.from_numpy(rng.randn(B, C, H, H).astype(np.float32)) \
        .to(device, bf16)
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
    flops = 2 * B * H * H * sum(9 * w.shape[2] * w.shape[3] for w in ws)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {card}; block ({B}, {C}, {H}, {H}) bf16, growth {G}",
          flush=True)

    table = variants()
    counters = {f.__name__: f for _, f in table.values()}
    for f in counters.values():
        f.launches = 0
    ref = None
    with torch.inference_mode(), no_tf32():
        for name in args.variants.split(","):
            if name == "lax":
                t = time_ms(lambda: lax_block(x, ws, bs), device, ITERS)
                ref = lax_block(x, ws, bs)
                print(f"lax        : {t:7.3f} ms  "
                      f"{flops / (t * 1e-3) / 1e12:6.1f} TF/s", flush=True)
                continue
            fn, counter = table[name]
            unit = "TOP/s" if name == "v8" else "TF/s"
            for rows in (int(r) for r in args.rows.split(",")):
                if H % rows:
                    continue
                try:
                    def call():
                        return fn(x, ws, bs, rows=rows)

                    t = time_ms(call, device, ITERS)
                    before = counter.launches
                    y = call()
                    per_call = counter.launches - before
                    err = ((y.float() - ref.float()).abs().max().item()
                           if ref is not None else float("nan"))
                    print(f"{name} rows={rows:2d}: {t:7.3f} ms  "
                          f"{flops / (t * 1e-3) / 1e12:6.1f} {unit}  "
                          f"maxerr {err:.1e}  launches {per_call}/call",
                          flush=True)
                except Exception as e:          # noqa: BLE001 (the JAX tool's)
                    print(f"{name} rows={rows:2d}: FAILED "
                          f"{type(e).__name__}: {str(e)[:200]}", flush=True)
    print("launches: " + json.dumps(
        {n: f.launches for n, f in counters.items()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
