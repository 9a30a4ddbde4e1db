"""Large-frame tiled inference, end to end: the port of the JAX package's
``tools/tiled_bench.py`` (BASELINE.json config 4: 2K detector frames
through overlap-blend tiling).

    python -m super_resolution_tpu_torch.tools.tiled_bench [--frame 2048] \\
        [--tile_w 128] [--halo 4] [--bucket_h 64] [--tile_batch 2] \\
        [--conv_impl pallas_cf] [--decompose]

Times the whole production path on the device, ``parallel.tiling.
tiled_upscale``: tile extraction, the batched bf16 generator forwards
(the canonical 23-block RRDBNet, seeded weights), the window-weighted
scatter and the weight-map divide, on the host clock around a run ended
by a synchronise; the 8192² output stays on the device.  The best of
``--reps`` runs after a first one that builds the kernels.  The height
planner (``--bucket_h``, ``bucket_tile_h``) plans by
``parallel.tiling._HEIGHT_RATE_KNOTS``; ``--bucket_h 0`` takes the tile
height as given (``--tile``, default the frame height), which is how the
rate against tile height is measured.  ``--decompose`` also times the
stages alone (extract, infer, blend) on the same code paths.  Then the
kernel launches of one frame by counter, the tile batches, and the
launches of the whole run.  ``--fwd_cap``, ``--cf9`` and
``--fwd_carry`` tune TPU mechanisms and are refused.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from super_resolution_tpu_torch.tools import (
    CF9_REFUSED,
    FWD_CARRY_REFUSED,
    LANE_CAP_REFUSED,
    host_sync,
    launch_counters,
    read_launches,
    refuse,
    reset_launches,
)

SCALE = 4


def make_infer(conv_impl: str, device: torch.device):
    """The bf16 forward of the canonical generator, seeded weights."""
    from super_resolution_tpu_torch.config import GeneratorConfig
    from super_resolution_tpu_torch.models.rrdb import RRDBNet

    model = RRDBNet(GeneratorConfig(conv_impl=conv_impl),
                    torch.Generator().manual_seed(0))
    model = model.to(device).eval().prepare(torch.bfloat16)

    def infer(x):
        with torch.inference_mode():
            return model(x)

    return infer


def make_frame(frame_h: int, frame_w: int, device: torch.device):
    """The seeded (H, W, 3) float32 LR frame in [0, 1)."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.rand(frame_h, frame_w, 3)
                            .astype(np.float32)).to(device)


def run_frame(infer, lr, args):
    """One frame through ``tiled_upscale`` with the flags' geometry."""
    from super_resolution_tpu_torch.parallel.tiling import tiled_upscale

    return tiled_upscale(infer, lr, scale=SCALE, tile=args.tile,
                         halo=args.halo, tile_batch=args.tile_batch,
                         tile_w=args.tile_w, bucket_h=args.bucket_h)


def stages(infer, lr, args):
    """The pipeline's stages as ``tiled_upscale`` runs them, each a
    function: (extract, infer, blend), the blended frame is blend()'s
    value."""
    from super_resolution_tpu_torch.parallel.tiling import (
        _blend_scatter,
        _ramp,
        _weight_profiles,
        bucket_tile_h,
        extract_tiles,
    )

    h, w, _ = lr.shape
    tile_h = args.tile
    if args.bucket_h is not None:
        tile_h = bucket_tile_h(h, args.tile, args.halo, args.bucket_h)
    tiles, ((t_h, t_w), oys, oxs) = extract_tiles(lr, tile_h, args.halo,
                                                  args.tile_w)
    group = args.tile_batch

    def infer_all():
        return [infer(tiles[s:s + group])
                for s in range(0, tiles.shape[0], group)]

    sr_tiles = torch.cat(infer_all())
    ramp_len = 2 * args.halo * SCALE
    py, px = _weight_profiles(oys, oxs, t_h, t_w, args.halo, SCALE,
                              h * SCALE, w * SCALE)
    grid = [(oy * SCALE, ox * SCALE) for oy in oys for ox in oxs]

    def blend():
        return _blend_scatter(sr_tiles, _ramp(t_h * SCALE, ramp_len),
                              _ramp(t_w * SCALE, ramp_len), py, px, grid,
                              h * SCALE, w * SCALE)

    return ((lambda: extract_tiles(lr, tile_h, args.halo, args.tile_w)),
            infer_all, blend)


def best_s(fn, device, reps: int) -> float:
    """The best host-clock seconds of ``reps`` synchronised calls, after
    one warm call."""
    fn()
    host_sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host_sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tiled_bench")
    ap.add_argument("--frame", type=int, default=2048,
                    help="LR frame size (square unless --frame_h)")
    ap.add_argument("--frame_h", type=int, default=None,
                    help="LR frame height when different from --frame")
    ap.add_argument("--bucket_h", type=int, default=64,
                    help="height-bucketed tile planning (tiled_upscale "
                         "bucket_h / CLI --tile_bucket): the tile height "
                         "becomes the multiple of this that the "
                         "rate-aware planner picks; 0 disables bucketing "
                         "(tile = --tile or the frame height)")
    ap.add_argument("--tile", type=int, default=None,
                    help="tile height cap (default: the frame height)")
    ap.add_argument("--tile_w", type=int, default=128,
                    help="tile width; --tile >= the frame height with a "
                         "narrow --tile_w is full-height column tiling "
                         "(overlap on one axis only)")
    ap.add_argument("--halo", type=int, default=4,
                    help="LR overlap half-width (the CLI ships 8 for "
                         "arbitrary checkpoints; tools.halo_parity "
                         "measures what a checkpoint admits)")
    ap.add_argument("--tile_batch", type=int, default=2)
    ap.add_argument("--conv_impl", default="pallas_cf")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--decompose", action="store_true",
                    help="also time the stages alone (extract / infer / "
                         "blend)")
    ap.add_argument("--fwd_cap", type=int, default=None,
                    help="refused: the Pallas forward's lane cap")
    ap.add_argument("--cf9", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="refused: the v9 routing is a TPU layout choice")
    ap.add_argument("--fwd_carry", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="refused: the fused forward's halo carry")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    refuse(args, fwd_cap=LANE_CAP_REFUSED, cf9=CF9_REFUSED,
           fwd_carry=FWD_CARRY_REFUSED)
    from super_resolution_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    frame_h = args.frame_h if args.frame_h is not None else args.frame
    if args.tile is None:
        args.tile = frame_h
    if args.bucket_h == 0:
        args.bucket_h = None

    infer = make_infer(args.conv_impl, device)
    lr = make_frame(frame_h, args.frame, device)
    counters = launch_counters()
    reset_launches(counters)

    t0 = time.perf_counter()
    run_frame(infer, lr, args)
    host_sync(device)
    print(f"[tiled] compile+first: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    before = read_launches(counters)
    run_frame(infer, lr, args)
    per_frame = {n: v - before[n] for n, v in read_launches(counters).items()
                 if v != before[n]}
    best = best_s(lambda: run_frame(infer, lr, args), device, args.reps)

    if args.decompose:
        for name, fn in zip(("extract", "infer", "blend"),
                            stages(infer, lr, args)):
            print(f"[tiled] stage {name:8s}: "
                  f"{best_s(fn, device, args.reps):.3f} s")

    from super_resolution_tpu_torch.parallel.tiling import (
        bucket_tile_h,
        plan_tiles,
    )

    tile_h = args.tile if args.bucket_h is None else bucket_tile_h(
        frame_h, args.tile, args.halo, args.bucket_h)
    _, oys, oxs = plan_tiles(frame_h, args.frame, tile_h, args.halo,
                             args.tile_w)
    n_tiles = len(oys) * len(oxs)
    out_mp = frame_h * args.frame * SCALE ** 2 / 1e6
    tw = args.tile if args.tile_w is None else args.tile_w
    print(f"[tiled] {args.frame}x{frame_h} LR -> "
          f"{args.frame * SCALE}x{frame_h * SCALE} SR "
          f"({args.conv_impl}, tile={args.tile}x{tw} "
          f"halo={args.halo} batch={args.tile_batch}"
          + (f" bucket_h={args.bucket_h}" if args.bucket_h else "")
          + f"): {best:.3f} s/frame = {out_mp / best:.2f} MP/s/chip")
    print(f"[tiled] tile {tile_h}x{min(tw, args.frame)}, {n_tiles} tiles, "
          f"{-(-n_tiles // args.tile_batch)} tile batches; launches/frame "
          f"{json.dumps(per_frame)}", flush=True)
    print("launches: " + json.dumps(read_launches(counters)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
