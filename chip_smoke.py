#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``super_resolution_tpu_torch``)
on one NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the script exits nonzero
and prints no result line:

1. the card (name and power limit from nvidia-smi), torch and CUDA;
   every kernel of the port built from ``csrc/`` with nvcc (timed).
2. kernel: the dense-block kernel against its plain PyTorch version on
   the card at six shapes (flagship bf16, odd-geometry fp32, the
   growth-64 slope-0.01 variant, a narrow one, and the two tile batches
   of the serve phase), within the tolerances below; times in turns (plain, kernel, library, library, kernel,
   plain) with CUDA events, the bound and the roofline share.
3. model: the full-width 23-block RRDBNet in bf16 on 8×128² LR tiles
   (seeded random weights) through ``train.steps.make_infer_fn``: the
   launch count of one forward, agreement with the same forward through
   the plain dense block (bf16 PSNR floor; fp32 tolerance on 2×64²), ms
   per batch and output MP/s.
4. serve: ``cli upscale`` and ``cli serve --once`` (two frames) on a
   synthetic RGBA frame that needs several tiles, with the full-width
   generator from a seeded BasicSR-named ``.pth``: ×4 shapes, alpha
   kept, serve bit-identical to upscale, a second ``--once`` processes
   0 frames, exactly one kernel launch per conv of every dense block
   of every tile batch, and both frames within the stated uint8 limits
   of ``cli upscale`` through the plain dense block.
5. the ``kernels`` JSON line, the card's name and power limit as
   nvidia-smi prints them, then the ``ok`` JSON line last.

It needs a CUDA card and the repository around it; without either it
exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                  # HBM3, bytes/s
# kernel vs plain, elementwise |k - p| <= atol + rtol*|p|.  bf16: about
# two bf16 ULPs — each conv output is rounded to bf16, and an f32 sum in
# another order can flip a rounding by one ULP that later convs of the
# block carry.  fp32: the same arithmetic in another summation order.
TOL = {"bfloat16": (2.0 ** -6, 2.0 ** -6), "float32": (2e-5, 1e-5)}
BF16_MODEL_PSNR_FLOOR_DB = 40.0    # kernel vs plain forward, 23 blocks
FP32_MODEL_TOL = (1e-4, 1e-4)      # (atol, rtol), kernel vs plain forward
# cli upscale in bf16 through the kernel vs through the plain dense
# block, uint8 frames (max and mean |delta| over all values).  bf16
# rounding flips, spread by 69 blocks of order-1 weights, move the
# frames of the serve phase by at most 4 LSB and 0.18 LSB on average on
# an H100 (NVIDIA H100 80GB HBM3, 700 W); a fault at a tile shape (a
# wrong row or column of outputs) moves values by tens of LSB.
CLI_PLAIN_MAX_LSB = 8
CLI_PLAIN_MEAN_LSB = 0.5
# Seeded weights of the model and serve phases.  nn.Conv2d's default
# init gives outputs of order 1 in which the 69 dense blocks move the
# result by several percent of its range; the repo's msra_scaled (x0.1)
# init leaves outputs near 1e-3 that barely depend on the trunk, so a
# kernel-vs-plain comparison through it would show little.
SEED_INIT = "torch_default"
REPLACES = ("super_resolution_tpu/ops/pallas/dense_block_cf.py:347 "
            "fused_dense_block_cf5; super_resolution_tpu/ops/pallas/"
            "dense_block_cf_ext.py:309 fused_dense_block_cf9")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def block_bound(shape, growth, dtype_name):
    """(bound_ms, bound_by, flops, bytes) of one dense block: each input
    (x, weights, biases) read once, y written once."""
    b, c, h, w = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    macs, wbytes, cin = 0, 0, c
    for k in range(5):
        cout = c if k == 4 else growth
        macs += 9 * cin * cout
        wbytes += 9 * cin * cout * elt + 4 * cout
        cin += growth
    flops = 2 * b * h * w * macs
    nbytes = 2 * b * c * h * w * elt + wbytes
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def kernel_phase():
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.dense_block import (
        dense_block,
        dense_block_plain,
        pack_weight,
    )

    cases = [  # name, (B, C, H, W), growth, dtype, slope
        ("flagship", (8, 64, 128, 128), 32, "bfloat16", 0.2),
        ("odd_fp32", (1, 64, 37, 53), 32, "float32", 0.2),
        ("growth64", (2, 64, 96, 80), 64, "bfloat16", 0.01),
        ("narrow", (2, 16, 40, 72), 8, "bfloat16", 0.2),
        # the tile batches of the serve phase's two frames (square 384
        # tiles; the 300-row frame is one short tile high)
        ("cli_tile", (2, 64, 384, 384), 32, "bfloat16", 0.2),
        ("cli_tile_short", (2, 64, 300, 384), 32, "bfloat16", 0.2),
    ]
    results = {}
    for name, shape, growth, dtype_name, slope in cases:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator().manual_seed(len(results))
        b, c, h, w = shape
        x = torch.randn(shape, generator=gen).to("cuda", dtype)
        ws, ws_oihw, bs = [], [], []
        cin = c
        for k in range(5):
            cout = c if k == 4 else growth
            wk = torch.randn(cout, cin, 3, 3, generator=gen) \
                * math.sqrt(2.0 / (9 * cin))
            ws_oihw.append(wk.to("cuda", dtype))
            ws.append(pack_weight(wk).to("cuda", dtype))
            bs.append((torch.randn(cout, generator=gen) * 0.1).to("cuda"))
            cin += growth
        kw = dict(res_scale=0.2, slope=slope)

        def kernel():
            return dense_block(x, ws, bs, **kw)

        def plain():
            return dense_block_plain(x, ws, bs, **kw)

        def library():
            # five cuDNN convs + torch.cat in the working dtype: a
            # yardstick of speed only, never called by the port
            feats = x
            bias = [bk.to(dtype) for bk in bs]
            for k in range(4):
                o = F.leaky_relu(F.conv2d(feats, ws_oihw[k], bias[k],
                                          padding=1), slope)
                feats = torch.cat([feats, o], 1)
            return x + 0.2 * F.conv2d(feats, ws_oihw[4], bias[4], padding=1)

        with torch.inference_mode(), no_tf32():
            y = kernel()
            torch.cuda.synchronize()
            ref = plain()
            if y.shape != ref.shape or y.dtype != ref.dtype:
                fail(f"{name}: kernel gave {y.shape} {y.dtype}, plain "
                     f"{ref.shape} {ref.dtype}")
            diff = (y.float() - ref.float()).abs()
            atol, rtol = TOL[dtype_name]
            worst = (diff - rtol * ref.float().abs()).max().item()
            max_err = diff.max().item()
            ok = bool(torch.isfinite(y.float()).all()) and worst <= atol
            iters = 20 if h * w * b >= 1 << 16 else 50
            for fn in (plain, kernel, library):
                fn()
            times = {"plain": [], "kernel": [], "library": []}
            for label in ("plain", "kernel", "library", "library",
                          "kernel", "plain"):
                fn = {"plain": plain, "kernel": kernel,
                      "library": library}[label]
                times[label].append(time_ms(fn, iters))
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        bound_ms, bound_by, flops, nbytes = block_bound(shape, growth,
                                                        dtype_name)
        results[name] = dict(
            shape=list(shape), growth=growth, dtype=dtype_name, slope=slope,
            max_abs_err=max_err, atol=atol, rtol=rtol, ok=ok,
            kernel_ms=ms["kernel"], plain_ms=ms["plain"],
            library_ms=ms["library"], bound_ms=bound_ms, bound_by=bound_by,
            flops=flops, bytes=nbytes,
            roofline_share=bound_ms / ms["kernel"],
            tflops=flops / (ms["kernel"] * 1e-3) / 1e12)
        print("[kernel] " + json.dumps({name: results[name]}), flush=True)
        if not ok:
            fail(f"{name}: kernel disagrees with its plain version "
                 f"(max |err| {max_err}, tolerance atol {atol} + rtol "
                 f"{rtol}·|plain|)")
    return results


def model_phase():
    import numpy as np
    import torch

    import super_resolution_tpu_torch.models.rrdb as rrdb
    from super_resolution_tpu_torch.config import GeneratorConfig, InferConfig
    from super_resolution_tpu_torch.ops.dense_block import (
        LAUNCHES_PER_BLOCK,
        dense_block,
        dense_block_plain,
    )
    from super_resolution_tpu_torch.train.steps import make_infer_fn

    gcfg = GeneratorConfig(init=SEED_INIT)    # 23 blocks, 64 / 32
    sd = rrdb.RRDBNet(gcfg, torch.Generator().manual_seed(0)).state_dict()
    infer = make_infer_fn(InferConfig(compute_dtype="bfloat16"), sd, "cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 128, 128, 3))
                         .astype(np.float32)).cuda()
    infer(x)                                  # warm-up
    torch.cuda.synchronize()

    dense_block.launches = 0
    out = infer(x)
    torch.cuda.synchronize()
    launches = dense_block.launches
    n_blocks = gcfg.n_blocks * gcfg.n_dense
    want = n_blocks * LAUNCHES_PER_BLOCK
    print(f"[model] dense-block launches in one forward: {launches} "
          f"(want {n_blocks} blocks x {LAUNCHES_PER_BLOCK} = {want})",
          flush=True)
    if launches != want:
        fail(f"launch count {launches} != {want}")
    if tuple(out.shape) != (8, 512, 512, 3) or \
            not bool(torch.isfinite(out).all()):
        fail(f"model output {tuple(out.shape)} is not finite (8,512,512,3)")

    def through_plain(fn, arg):
        orig = rrdb.dense_block
        rrdb.dense_block = dense_block_plain
        try:
            return fn(arg)
        finally:
            rrdb.dense_block = orig

    ref = through_plain(infer, x)
    rng_ = (ref.max() - ref.min()).item()
    mse = ((out - ref) ** 2).mean().item()
    psnr = 10 * math.log10(rng_ ** 2 / mse) if mse > 0 else float("inf")
    print(f"[model] bf16 kernel vs plain forward: PSNR {psnr:.2f} dB over "
          f"the output range {rng_:.4f} (floor "
          f"{BF16_MODEL_PSNR_FLOOR_DB} dB), max |err| "
          f"{(out - ref).abs().max().item():.6g}", flush=True)
    if not psnr >= BF16_MODEL_PSNR_FLOOR_DB:
        fail(f"bf16 model PSNR {psnr} dB below the floor")

    infer32 = make_infer_fn(InferConfig(compute_dtype="float32"), sd, "cuda")
    x32 = x[:2, :64, :64].contiguous()
    out32 = infer32(x32)
    ref32 = through_plain(infer32, x32)
    atol, rtol = FP32_MODEL_TOL
    err32 = (out32 - ref32).abs()
    worst = (err32 - rtol * ref32.abs()).max().item()
    print(f"[model] fp32 kernel vs plain forward (2x64x64): max |err| "
          f"{err32.max().item():.6g} (tolerance atol {atol} + rtol "
          f"{rtol}·|plain|)", flush=True)
    if not worst <= atol:
        fail("fp32 model disagrees with the plain forward")

    times = [time_ms(lambda: infer(x), 5) for _ in range(3)]
    ms = sorted(times)[1]
    mps = 8 * 512 * 512 / 1e6 / (ms / 1e3)
    flops, block_flops = forward_flops(gcfg, 8, 128, 128)
    bound_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    print(f"[model] 23-block bf16 8x128x128 -> 8x512x512: {ms:.3f} ms per "
          f"batch (median of 3 x 5 forwards: "
          f"{', '.join(f'{t:.3f}' for t in times)}), {mps:.3f} output "
          f"MP/s; {flops / 1e12:.4f} TFLOP per forward, "
          f"{block_flops / flops:.4f} of it in the dense blocks; bound "
          f"{bound_ms:.3f} ms, roofline share {bound_ms / ms:.4f}",
          flush=True)
    profile_forward(infer, x, ms)
    return dict(launches=launches, want=want, psnr_db=psnr, ms=ms,
                mp_per_s=mps)


def forward_flops(gcfg, b, h, w):
    """(all, dense-block) FLOPs of one generator forward on b x h x w LR
    tiles, from the layer shapes: 2 per multiply-add of every 3x3 conv."""
    nf, gc = gcfg.filters, gcfg.growth
    conv = 2 * 9 * nf * nf                      # one nf -> nf conv, per pixel
    block = 2 * 9 * sum((nf + k * gc) * (nf if k == 4 else gc)
                        for k in range(5))
    lr = (2 * 9 * gcfg.channels * nf                       # conv_first
          + gcfg.n_blocks * gcfg.n_dense * block           # the trunk
          + conv)                                          # conv_body
    hr = 0
    for u in range(1, gcfg.n_upsample + 1):               # conv_up{u}
        if gcfg.upsampler == "nearest_conv":
            hr += conv * 4 ** u              # after the x2 nearest repeat
        else:
            hr += 4 * conv * 4 ** (u - 1)    # nf -> 4 nf, then the shuffle
    hr += (conv + 2 * 9 * nf * gcfg.channels) * 4 ** gcfg.n_upsample
    pix = b * h * w
    return pix * (lr + hr), pix * gcfg.n_blocks * gcfg.n_dense * block


def profile_forward(infer, x, ms):
    """Device time of one forward by kernel, from torch.profiler: the
    dense-block kernel's share and the device's idle share of the
    unprofiled ms per batch.  Prints 'not measured' where the profiler
    records no device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        infer(x)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    if not by_name:
        print("[profile] device time by kernel: not measured (the profiler "
              "recorded no CUDA kernels)", flush=True)
        return
    busy = sum(by_name.values())
    dense = sum(t for n, t in by_name.items() if "conv3x3_" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print("[profile] " + json.dumps({
        "device_busy_ms": busy, "dense_block_kernel_ms": dense,
        "dense_block_share_of_busy": dense / busy,
        "idle_share_of_batch": max(0.0, 1 - busy / ms),
        "top_kernels_ms": {n[:90]: t for n, t in top}}), flush=True)


def serve_phase():
    import numpy as np
    import torch
    from PIL import Image

    import super_resolution_tpu_torch.models.rrdb as rrdb
    from super_resolution_tpu_torch import cli
    from super_resolution_tpu_torch.config import GeneratorConfig
    from super_resolution_tpu_torch.data.image_io import upscale_alpha
    from super_resolution_tpu_torch.ops.dense_block import (
        LAUNCHES_PER_BLOCK,
        dense_block,
        dense_block_plain,
    )
    from super_resolution_tpu_torch.parallel.tiling import plan_tiles

    gcfg = GeneratorConfig()
    tile, halo, tile_batch = 384, 8, 2        # the CLI's defaults

    def launches_for(h, w):
        """Kernel launches the CLI makes for one h x w frame."""
        _, oys, oxs = plan_tiles(h, w, tile, halo)
        forwards = math.ceil(len(oys) * len(oxs) / tile_batch)
        return forwards * gcfg.n_blocks * gcfg.n_dense * LAUNCHES_PER_BLOCK

    rng = np.random.default_rng(1)

    def frame(h, w):
        yy, xx = np.mgrid[0:h, 0:w]
        rgb = np.stack([(xx * 255 // w), (yy * 255 // h),
                        ((xx + yy) * 255 // (h + w))], -1).astype(np.int16)
        rgb = np.clip(rgb + rng.integers(-20, 21, rgb.shape), 0, 255)
        alpha = (128 + 127 * np.sin(xx / 17.0) * np.cos(yy / 23.0))
        return np.concatenate([rgb, alpha[..., None]], -1).astype(np.uint8)

    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "g.pth")
        torch.save(rrdb.RRDBNet(GeneratorConfig(init=SEED_INIT),
                           torch.Generator().manual_seed(1)).state_dict(), pth)
        watch, out_dir = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(watch)
        frames = {"a": frame(520, 820), "b": frame(300, 400)}
        for k, img in frames.items():
            Image.fromarray(img, "RGBA").save(os.path.join(watch, f"{k}.png"))
        sr_path = os.path.join(tmp, "sr.png")

        dense_block.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["upscale", "--image", os.path.join(watch, "a.png"),
                       "--checkpoint", pth, "--out", sr_path])
        up_s = time.perf_counter() - t0
        up_launches = dense_block.launches
        if rc != 0:
            fail(f"cli upscale returned {rc}")
        sr = np.asarray(Image.open(sr_path))
        if sr.shape != (520 * 4, 820 * 4, 4):
            fail(f"upscale output {sr.shape}, want (2080, 3280, 4)")
        if not np.array_equal(sr[..., 3],
                              upscale_alpha(frames["a"][..., 3], 4, "cuda")):
            fail("upscale did not keep the alpha plane")

        dense_block.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["serve", "--checkpoint", pth, "--watch", watch,
                       "--out", out_dir, "--once"])
        serve_s = time.perf_counter() - t0
        serve_launches = dense_block.launches
        if rc != 0:
            fail(f"cli serve returned {rc}")
        with open(os.path.join(out_dir, "serve_log.jsonl")) as f:
            n_first = len(f.read().splitlines())
        sa = np.asarray(Image.open(os.path.join(out_dir, "a_x4.png")))
        sb = np.asarray(Image.open(os.path.join(out_dir, "b_x4.png")))
        if n_first != 2 or sb.shape != (1200, 1600, 4):
            fail(f"serve processed {n_first} frames, b -> {sb.shape}")
        if not np.array_equal(sa, sr):
            fail("serve output differs from upscale output")
        rc = cli.main(["serve", "--checkpoint", pth, "--watch", watch,
                       "--out", out_dir, "--once"])
        with open(os.path.join(out_dir, "serve_log.jsonl")) as f:
            n_second = len(f.read().splitlines()) - n_first
        if rc != 0 or n_second != 0:
            fail(f"second serve --once processed {n_second} frames")

        # the same frames through the plain dense block: the kernel at
        # the CLI's tile batches and dtype, held to CLI_PLAIN_MAX_LSB
        plain_delta = {}
        orig = rrdb.dense_block
        rrdb.dense_block = dense_block_plain
        try:
            for k, got in (("a", sr), ("b", sb)):
                ref_path = os.path.join(tmp, f"{k}_plain.png")
                rc = cli.main(["upscale", "--image",
                               os.path.join(watch, f"{k}.png"),
                               "--checkpoint", pth, "--out", ref_path])
                if rc != 0:
                    fail(f"cli upscale through the plain block returned {rc}")
                ref = np.asarray(Image.open(ref_path)).astype(np.int16)
                d = np.abs(got.astype(np.int16) - ref)
                plain_delta[k] = dict(max_lsb=int(d.max()),
                                      mean_lsb=float(d.mean()),
                                      share_differing=float((d > 0).mean()))
        finally:
            rrdb.dense_block = orig
    print("[serve] uint8 delta, kernel vs plain dense block (limits: max "
          f"{CLI_PLAIN_MAX_LSB} LSB, mean {CLI_PLAIN_MEAN_LSB} LSB): "
          + json.dumps(plain_delta), flush=True)
    for k, v in plain_delta.items():
        if v["max_lsb"] > CLI_PLAIN_MAX_LSB or \
                v["mean_lsb"] > CLI_PLAIN_MEAN_LSB:
            fail(f"cli upscale of frame {k} through the kernel differs "
                 f"from the plain dense block beyond the limits: {v}")
    want_up = launches_for(520, 820)
    want_serve = want_up + launches_for(300, 400)
    print(f"[serve] dense-block launches: upscale {up_launches} (want "
          f"{want_up}), serve {serve_launches} (want {want_serve})",
          flush=True)
    if up_launches != want_up or serve_launches != want_serve:
        fail("the CLI path did not launch the dense-block kernel once per "
             "conv of every dense block of every tile batch")
    res = dict(upscale_s=up_s, upscale_launches=up_launches,
               serve_s=serve_s, serve_launches=serve_launches,
               second_run_frames=n_second, plain_delta=plain_delta)
    print("[serve] " + json.dumps(res), flush=True)
    return res


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "super_resolution_tpu_torch")):
        print("chip_smoke: the super_resolution_tpu_torch package is not "
              f"beside {__file__}; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this smoke test runs "
              "only on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}", flush=True)

    from super_resolution_tpu_torch import build

    t0 = time.perf_counter()
    for name in build.SOURCES:
        build.load(name)
    print(f"[build] {len(build.SOURCES)} kernel source(s) built with nvcc "
          f"for sm_90a in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(os.path.relpath(build.library_path(n), HERE)
                      for n in build.SOURCES), flush=True)

    kern = kernel_phase()
    model_phase()
    serve = serve_phase()

    flag = kern["flagship"]
    print(json.dumps({"kernels": [{
        "name": "dense_block",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/dense_block.cu",
        "replaces": REPLACES,
        # the user's entry points: cli upscale, then cli serve --once
        "launches": serve["upscale_launches"] + serve["serve_launches"],
        "max_abs_err": flag["max_abs_err"],
        "ms": flag["kernel_ms"],
        "plain_ms": flag["plain_ms"],
        "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"],
        "library_ms": flag["library_ms"],
    }]}))
    print(smi)                       # card name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
