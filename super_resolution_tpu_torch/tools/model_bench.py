"""The full model over dense-block variant combinations: the port of the
JAX package's ``tools/model_bench.py``.

    python -m super_resolution_tpu_torch.tools.model_bench \\
        [--variants lax,v4+laxtail,v5+laxtail,v4+ktail,v5+ktail]

The canonical 23-block ×4 generator (seeded weights, bf16) on a
(batch, tile, tile_w) LR batch.  Variants: ``lax`` (``conv_impl="lax"``:
cuDNN, no kernel), ``prod`` (the shipping configuration, ``auto``), and
``{v4,v5,v6,v9}+{laxtail,ktail}``: the dense blocks through that variant,
swapped in through ``models.rrdb``'s module-level ``dense_block`` as the
JAX tool swaps its seam; the tail on cuDNN (``laxtail``, under
``pallas_cf``) or through the single-conv kernel (``ktail``, under
``pallas_cf_tail``).  Diagnostic only: the product picks its path with
``GeneratorConfig.conv_impl``.  A line per variant: ms per batch (best of
three runs of ``--iters`` forwards, CUDA events), output MP/s, the time
of the first call, and the kernel launches of one forward by counter;
then the launches of the whole run by counter.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time

import torch

from super_resolution_tpu_torch.config import GeneratorConfig
from super_resolution_tpu_torch.device import resolve_device
from super_resolution_tpu_torch.ops.dense_block import unpack_weight
from super_resolution_tpu_torch.tools import (
    FWD_CARRY_REFUSED,
    time_ms,
    variants,
)

TILE, BATCH, ITERS = 128, 8, 10
BLOCKS = ("v4", "v5", "v6", "v9")


def _swapped(fn):
    """A variant of HWIO weights behind ``dense_block``'s interface
    (packed weights): the packed tensors viewed as HWIO, no copy; the
    band height is the variant's default where it divides H."""
    default = fn.__kwdefaults__["rows"]

    def block(x, ws, bs, *, res_scale, slope):
        h = x.shape[2]
        rows = next(r for r in (default, 32, 16, 8, h) if h % r == 0)
        return fn(x, [unpack_weight(w).permute(2, 3, 1, 0) for w in ws],
                  bs, rows=rows, res_scale=res_scale, slope=slope)

    return block


def main(argv=None):
    ap = argparse.ArgumentParser(prog="model_bench")
    ap.add_argument("--variants",
                    default="lax,v4+laxtail,v5+laxtail,v4+ktail,v5+ktail")
    ap.add_argument("--fwd_carry", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="refused: the TPU kernel's halo carry is not "
                         "ported")
    ap.add_argument("--tile", type=int, default=TILE,
                    help="LR side length (default %(default)s)")
    ap.add_argument("--tile_w", type=int, default=None,
                    help="LR width if different from --tile")
    ap.add_argument("--batch", type=int, default=BATCH,
                    help="batch size (default %(default)s)")
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="forwards per timed run")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    if args.fwd_carry is not None:
        raise SystemExit(FWD_CARRY_REFUSED)
    device = resolve_device(args.device)
    tile, batch, iters = args.tile, args.batch, args.iters
    tile_w = args.tile_w if args.tile_w is not None else tile

    rrdb = importlib.import_module("super_resolution_tpu_torch.models.rrdb")
    c3 = importlib.import_module("super_resolution_tpu_torch.ops.conv3x3")
    table = variants()
    counters = {f.__name__: f for _, f in table.values()}
    counters["conv3x3"] = c3.conv3x3
    sd = rrdb.RRDBNet(GeneratorConfig(),
                      torch.Generator().manual_seed(0)).state_dict()
    x = torch.randn(batch, tile, tile_w, 3,
                    generator=torch.Generator().manual_seed(1)).to(device)
    orig_block = rrdb.dense_block
    for f in counters.values():
        f.launches = 0

    for variant in args.variants.split(","):
        impl = ("lax" if variant == "lax"
                else "auto" if variant == "prod" else "pallas_cf")
        try:
            if "+" in variant:
                block, tail = variant.split("+")
                if block not in BLOCKS or tail not in ("laxtail", "ktail"):
                    raise ValueError(f"unknown variant {variant!r}")
                fn = table[block][0]
                if block in ("v4", "v6"):
                    rrdb.dense_block = _swapped(fn)
                impl = "pallas_cf_tail" if tail == "ktail" else "pallas_cf"
            model = rrdb.RRDBNet(GeneratorConfig(conv_impl=impl))
            model.load_state_dict(sd)
            model.to(device).prepare(torch.bfloat16)
            with torch.inference_mode():
                t0 = time.perf_counter()
                model(x)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                first_s = time.perf_counter() - t0
                before = {n: f.launches for n, f in counters.items()}
                model(x)
                launches = {n: f.launches - before[n]
                            for n, f in counters.items()
                            if f.launches != before[n]}
                per_batch = min(time_ms(lambda: model(x), device, iters,
                                        warmup=0) for _ in range(3))
            mp_s = batch * (tile * 4) * (tile_w * 4) / 1e6 / (per_batch / 1e3)
            print(f"{variant:12s}: {per_batch:6.1f} ms/batch  {mp_s:6.2f} "
                  f"MP/s  (first call {first_s:.1f}s)  launches "
                  f"{json.dumps(launches)}", flush=True)
        except Exception as e:                  # noqa: BLE001 (the JAX tool's)
            print(f"{variant:12s}: FAILED {type(e).__name__}: "
                  f"{str(e)[:160]}", flush=True)
        finally:
            rrdb.dense_block = orig_block
    print("launches: " + json.dumps(
        {n: f.launches for n, f in counters.items()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
