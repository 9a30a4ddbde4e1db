"""Correctness harness of the dense-block kernel variants against a
float32 reference block: the port of the JAX package's
``tools/kernel_dev_check.py``.

    python -m super_resolution_tpu_torch.tools.kernel_dev_check \\
        [v3b|v4|v5|v6|v8] [--device cuda]

The JAX tool's five cases (numpy ``RandomState(0)``), float32.  On the
card the variant's kernel runs, with ``--device cpu`` its plain version.
The reference is the textbook block: five ``F.conv2d`` in float32 (TF32
off) with the bias, LeakyReLU and residual in float32.  v3b–v6 are held
to max |err| < 2e-4, as the JAX tool holds them.  v8 (int8 with dynamic
quantization) would fail that by design; it is held to max |err| < 0.05
of the largest |y|: ``tests/test_pallas.py``'s int8 class is 0.02 at its
16-channel case, and at this tool's 64-channel cases the JAX kernel
itself is 3.7e-2 to 4.2e-2 from the float32 block (in interpret mode on
the CPU), which the port's v8 equals.  Exits nonzero at the first case
outside.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.device import no_tf32, resolve_device
from super_resolution_tpu_torch.tools import variants

CASES = [(1, 16, 32, 16, 8, 8), (2, 16, 24, 24, 8, 8),
         (1, 64, 64, 128, 32, 32), (1, 64, 32, 128, 32, 16),
         (1, 64, 96, 128, 32, 32)]      # (B, C, H, W, growth, rows)
ABS_TOL = 2e-4
INT8_REL_TOL = 0.05


def reference_block(x, ws, bs, slope=0.2, res=0.2):
    """The float32 block: conv, bias and LeakyReLU per conv, concat,
    residual."""
    feats, out = x, x
    for k, (w, b) in enumerate(zip(ws, bs)):
        out = F.conv2d(feats, w.permute(3, 2, 0, 1), b, padding=1)
        if k < len(ws) - 1:
            out = torch.where(out >= 0, out, slope * out)
            feats = torch.cat([feats, out], 1)
    return x + res * out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kernel_dev_check")
    ap.add_argument("which", nargs="?", default="v4",
                    choices=("v3b", "v4", "v5", "v6", "v8"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    which, device = args.which, resolve_device(args.device)
    fn = variants()[which][0]
    rng = np.random.RandomState(0)
    for (B, C, H, W, G, rows) in CASES:
        x = torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32))
        ws, bs = [], []
        cin = C
        for k in range(5):
            co = C if k == 4 else G
            ws.append(torch.from_numpy(
                rng.randn(3, 3, cin, co).astype(np.float32) * 0.1))
            bs.append(torch.from_numpy(rng.randn(co).astype(np.float32)
                                       * 0.1))
            if k < 4:
                cin += co
        x = x.to(device)
        ws = [w.to(device) for w in ws]
        bs = [b.to(device) for b in bs]
        with torch.inference_mode(), no_tf32():
            ref = reference_block(x, ws, bs)
            got = fn(x, ws, bs, rows=rows)
        err = (got - ref).abs().max().item()
        line = f"{which} B{B} C{C} H{H}x{W} rows{rows}: max err {err:.2e}"
        if which == "v8":
            rel = err / ref.abs().max().item()
            print(f"{line} ({rel:.2e} of the largest |y|)", flush=True)
            ok = rel < INT8_REL_TOL
        else:
            print(line, flush=True)
            ok = err < ABS_TOL
        if not ok:
            raise SystemExit(f"{which}: case B{B} C{C} H{H}x{W} rows{rows} "
                             f"is outside its tolerance")
    print(f"{which} matches the float32 block on all cases "
          f"({device.type})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
