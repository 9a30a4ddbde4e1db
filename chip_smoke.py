#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``super_resolution_tpu_torch``)
on one NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the script exits nonzero
and prints no result line:

1. the card (name and power limit from nvidia-smi), torch and CUDA;
   every kernel of the port built from ``csrc/`` with nvcc (timed), and
   what ``ptxas -v`` reports for each kernel of the Hopper tile
   (``csrc/conv3x3_wgmma.cuh``): registers, shared memory, spills, with
   the tile's plan (N, K chunk, stages, weights resident, dynamic shared
   memory) at the main path's shapes.  Then the tile's load path: a
   dense block whose buffer is NaN from each conv's cin upward before
   its launch, a single conv from a channel prefix of one buffer into a
   channel slice of another (neighbours unchanged bit for bit), bf16
   planes whose H and W are not multiples of 16, and the 64 -> 256
   upconv, each against its plain version.
2. kernel: the dense-block forward kernel against its plain PyTorch
   version on the card at seven shapes (flagship bf16, odd-geometry
   fp32, the growth-64 slope-0.01 variant, a narrow one, the two tile
   batches of the serve phase and the training shape), within the
   tolerances below; times in turns (plain, kernel, library, library,
   kernel, plain) with CUDA events, the bound and the roofline share.
   Then the backward kernels against their plain version at five shapes
   (the training shape (16, 64, 48, 48) bf16, odd fp32, growth 64 slope
   0.01, narrow, 48 x 6): in bf16 the Hopper design (a prep, the data
   gradient as one gather launch of the Hopper tile per conv, the
   weight gradient on wgmma, one reduction: 8 launches), in fp32 the
   FMA kernels (15): dx, every dW and db, two runs bit for bit, the
   launches, the same times (library: autograd through five cuDNN
   convs), the kernels' device time and the bound.
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
5. train: ``cli train --preset train_gan_dfm`` on synthetic patches at
   full width (23 blocks, bf16, batch 16 of 192 x 192 HR patches), three
   warmup and three GAN steps: launch counts per generator update
   against their formulas, finite metrics, a falling warmup loss, an EMA
   that trails the parameters, the checkpoint reloaded and upscaled by
   ``cli upscale``; one more GAN step from that checkpoint through the
   kernels against the same step through the plain dense block
   (forward and backward), a warmup step likewise with every gradient
   tensor held, and a float32 GAN step at a small geometry per gradient
   tensor; ms per step, HR MP/s, the device's idle share, top
   operations and the backward kernels' ms per step by name from
   ``torch.profiler``, peak memory.
6. kernel-conv3x3: the single-conv kernel against its plain version at
   the flagship tail's shapes (8 x 64 x 128^2, 256^2, 512^2 -> 64), at
   conv_first (8, 128, 128, 3) -> 64 and conv_last (8, 512, 512, 64) ->
   3, at the pixel-shuffle upconv (-> 256) and at an odd fp32 shape;
   max |err|, ms in turns (library: one cuDNN conv in bf16), the bound
   and the roofline share, and at 128^2 the cost of conv3x3_cf's one
   conversion of a contiguous NCHW input.
7. kernel-fused: the NHWC dense-block entry against its plain version at
   (8, 128, 128, 64) bf16 and an odd fp32 shape, the same fields.
8. impls: the flagship forward under conv_impl pallas_cf_tail, pallas
   and pallas_fused: launches of one forward against their formulas
   (345 dense + 4 tail; 351 single convs; 345 NHWC dense), kernel vs
   plain PSNR floor, ms per batch and MP/s, the device profile; then
   ``cli upscale --conv_impl X`` of the serve phase's frame: launches
   per tile batch, alpha kept, PSNR against the default impl's frame.
   ``lax`` (cuDNN, no kernel of the port) runs there too: 0 own-kernel
   launches, its frame against the default impl's, and one warmup and
   one GAN step of ``cli train --conv_impl pallas``, which trains on
   ``lax`` and says so.
9. train-tail: ``cli train --preset train_gan_dfm --conv_impl
   pallas_cf_tail``, two warmup and two GAN steps at full width: the
   dense-block and tail launches of every generator update, finite
   metrics.
10. kernel-experiments: the experiment variants v3, v3b, v4 (with and
   without ``save_acts``) and v6, routed to the dense-block kernel, at
   (8, 64, 128, 128) bf16 with their default band heights and at an odd
   fp32 shape: five launches per call on each wrapper's counter, the
   plain version within the forward tolerances, wrapper ms (weight
   packing included), the bound and cuDNN's time.
11. kernel-int8: the int8 kernels of v8 (weight prep, banding, the s8
   wgmma conv) at (8, 64, 128, 128) bf16, rows 16 and 32, and at an
   fp32 shape of growth 8: against its plain version within one ULP of
   x's dtype (the share of differing values printed), within 0.02 of
   the largest |y| of the bf16 dense-block kernel, rows 16 and 32
   giving other values (band-local scales), n + 2 = 7 launches per
   call, ms in turns with plain, the kernels' device time alone and by
   kernel (``torch.profiler``) beside the bf16 dense block's in the
   same call, the int8 bound; with ``CHIP_SMOKE_PARENT`` naming a
   checkout of an earlier commit, that commit's v8 on the same inputs,
   value for value.  The ``[build]`` lines give ptxas's report and
   plans of the int8 conv and, from ``cuobjdump -sass``, its int8 GMMA
   instructions (and that the library has no ``mma.sync``).
12. contract: the dense block's calling contract at five geometries
   (conv counts 3-5, channels and growth that are not multiples of 8,
   widths above 64), bf16 and fp32: the forward NCHW and NHWC, the
   backward (bit for bit twice), v3-v6 and v8 against their plain
   versions at the tolerances above, launches by their formulas; and an
   RRDBNet with 4 convs per dense block and growth 4 under auto and
   pallas_fused against the same forward through the plain kernels.
13. tools: ``python -m super_resolution_tpu_torch.tools.kernel_bench
   --variants lax,v3,v3b,v4,v5,v6,v8,v9`` and ``tools.model_bench`` over
   every variant (``--iters 3``) as subprocesses on the card: a time for
   every variant, no ``FAILED``, and per model forward 345 dense-block
   launches on each variant's own counter (+4 tail launches under
   ``ktail``), none under ``lax``.
14. the ``kernels`` JSON line, the card's name and power limit as
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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,   # H100 SXM, dense
              "int8": 1979e12}
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


REPLACES_BWD = ("super_resolution_tpu/ops/pallas/dense_block_cf_vjp.py:438 "
                "fused_dense_block_cf5_bwd")
# backward kernels vs plain, each tensor against its own largest value:
# max |k - p| <= tol * max |p|.  float32: sums over all pixels in another
# order.  bfloat16: dx is rounded to bf16 and carries rounding flips of
# the cotangents above it, like the forward (two ULPs); dW and db sum
# tens of thousands of pixels, so a flipped rounding of a few cotangents
# moves them by far less than one bf16 ULP of their largest entry.
BWD_TOL = {"bfloat16": dict(dx=2.0 ** -6, dw=2.0 ** -8, db=2.0 ** -8),
           "float32": dict(dx=1e-4, dw=1e-4, db=1e-4)}
TRAIN_SHAPE = (16, 64, 48, 48)     # one dense block's input in training
# A training step through the kernels vs through the plain dense block,
# full width, bf16, from the checkpoint of the train phase.  The two
# forwards differ by bf16 rounding flips (model phase), which the losses
# average over all pixels.  In the warmup step the cotangent of SR is
# sign(SR - HR) / n, the same on both sides, so G's gradients differ
# only by the flips of 69 blocks' backward: each tensor is held to 5e-2
# of its largest value.  In the GAN step the cotangent comes through D,
# whose BatchNorms see the almost constant SR image of a barely trained
# G: their E[x^2] - E[x]^2 cancels and amplifies the flips, so there
# only the losses and the gradient norms are held, the norm of G's
# loosely (measured 0.047 on an NVIDIA H100 80GB HBM3, 700 W; a missing
# or doubled term moves it by tens of percent).
STEP_LOSS_RTOL = 1e-2
STEP_GRAD_NORM_RTOL = 1e-1
STEP_WARMUP_GRAD_TOL = 5e-2
# the same at a small float32 geometry, per gradient tensor, against
# the tensor's largest value: summation order only
STEP_FP32_GRAD_TOL = 1e-4
REPLACES_CONV = ("super_resolution_tpu/ops/pallas/conv_cf.py:67 "
                 "conv3x3_cf_fwd; super_resolution_tpu/ops/pallas/"
                 "packed_conv.py:72 packed_conv3x3")
REPLACES_NHWC = ("super_resolution_tpu/ops/pallas/dense_block.py:129 "
                 "fused_dense_block")
# the single-conv kernel vs plain, elementwise: both round the same f32
# sum once, so bf16 one ULP (another summation order can flip the
# rounding); fp32 the summation order only
CONV_TOL = {"bfloat16": (2.0 ** -8, 2.0 ** -7), "float32": (2e-5, 1e-5)}
# cli upscale of the serve frame under another conv impl against the
# default impl's frame, uint8 PSNR.  The impls compute one function but
# round in other places in bf16 (pallas: every conv rounded, LeakyReLU and
# both residuals in bf16; pallas_cf_tail: the tail rounded once with an
# f32 bias), which moves a frame by a few LSB (52-56 dB, at most 7 LSB,
# on an NVIDIA H100 80GB HBM3, 700 W); a fault at a tile, a channel or a
# stride moves whole regions of the frame, far below the floor.
CLI_IMPL_PSNR_FLOOR_DB = 35.0
REPLACES_EXPERIMENTS = (
    "super_resolution_tpu/ops/pallas/experiments_dense_block.py:122 "
    "fused_dense_block_cf; :262 fused_dense_block_cf2; :379 "
    "fused_dense_block_cf3; :521 fused_dense_block_cf6")
REPLACES_INT8 = ("super_resolution_tpu/ops/pallas/experiments_dense_block.py"
                 ":668 fused_dense_block_cf8")
# the int8 block against the bf16 dense-block kernel, max |delta| over
# the largest |y|: tests/test_pallas.py's class for v8 (measured 0.0065
# on the CPU at (1, 64, 32, 128) with these weights)
INT8_CLASS_REL = 0.02


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


def block_convs(c, growth, n=5):
    """(cin, cout) of each conv of an n-conv dense block."""
    return [(c + k * growth, c if k == n - 1 else growth) for k in range(n)]


def block_bound(shape, growth, dtype_name, n=5):
    """(bound_ms, bound_by, flops, bytes) of one n-conv dense block: each
    input (x, weights, biases) read once, y written once."""
    b, c, h, w = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    convs = block_convs(c, growth, n)
    macs = sum(9 * cin * cout for cin, cout in convs)
    wbytes = sum(9 * cin * cout * elt + 4 * cout for cin, cout in convs)
    flops = 2 * b * h * w * macs
    nbytes = 2 * b * c * h * w * elt + wbytes
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def make_block(shape, growth, dtype, seed):
    """Seeded x, packed weights, OIHW weights and biases of one dense
    block on the card."""
    import torch

    from super_resolution_tpu_torch.ops.dense_block import pack_weight

    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
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
    return x, ws, ws_oihw, bs


def cudnn_block(x, ws_oihw, bs, slope=0.2):
    """Five cuDNN convs + torch.cat in the working dtype: the library
    yardstick of a dense block, never called by the port."""
    import torch
    import torch.nn.functional as F

    feats = x
    bias = [bk.to(x.dtype) for bk in bs]
    for k in range(4):
        o = F.leaky_relu(F.conv2d(feats, ws_oihw[k], bias[k], padding=1),
                         slope)
        feats = torch.cat([feats, o], 1)
    return x + 0.2 * F.conv2d(feats, ws_oihw[4], bias[4], padding=1)


def ptxas_lines(build):
    """One line per library: what ptxas reported for each kernel of the
    Hopper tile (conv3x3_wgmma<N, K chunk, output dtype>), and for the
    bf16 backward's kernels."""
    import re

    pat = re.compile(r"conv3x3_wgmmaILi(\d+)ELi(\d+)E(13__nv_bfloat16|f)")
    lines = []
    for name in ("dense_block", "conv3x3"):
        parts = []
        for k in build.ptxas_report(name):
            m = pat.search(k["kernel"])
            if not m:
                continue
            out = "bf16" if m.group(3) != "f" else "f32"
            parts.append(
                f"<{m.group(1)},{m.group(2)},{out}> {k['registers']} regs, "
                f"{k['smem_bytes']} B static smem, spills "
                f"{k['spill_stores']}/{k['spill_loads']} B"
                + (f", {len(k['notes'])} wgmma notes: {k['notes']}"
                   if k["notes"] else ""))
        if not parts:
            fail(f"no ptxas report of the Hopper tile in {name}'s build")
        lines.append(f"[build] ptxas -v, {name}: conv3x3_wgmma"
                     + "; ".join(parts))
    # the bf16 backward: the tile with the backward epilogues (the data
    # gradient) and its own kernels
    parts = []
    for k in build.ptxas_report("dense_block_bwd"):
        m = pat.search(k["kernel"])
        name = (f"conv3x3_wgmma<{m.group(1)},{m.group(2)},f32,bwd>" if m
                else next((n for n in ("wgrad_wgmma", "bwd_prep",
                                       "bwd_reduce", "dgrad3x3", "wgrad3x3",
                                       "wgrad_reduce")
                           if n in k["kernel"]), None))
        if name is None:
            continue
        parts.append(
            f"{name} {k['registers']} regs, {k['smem_bytes']} B static "
            f"smem, spills {k['spill_stores']}/{k['spill_loads']} B"
            + (f", {len(k['notes'])} wgmma notes: {k['notes']}"
               if k["notes"] else ""))
    if not any("wgrad_wgmma" in p_ for p_ in parts):
        fail("no ptxas report of wgrad_wgmma in dense_block_bwd's build")
    lines.append("[build] ptxas -v, dense_block_bwd: " + "; ".join(parts))
    return lines


# (cout, cin, out_bf16) of the main path's convs: dense-block convs 1-5,
# the tail's 64 -> 64, conv_first (padded to 8), conv_last, the upconv
PLAN_SHAPES = ((32, 64, 1), (32, 96, 1), (32, 128, 1), (32, 160, 1),
               (64, 192, 1), (64, 64, 1), (64, 8, 1), (3, 64, 1),
               (256, 64, 1))


def plan_line():
    """The Hopper tile's plan at the main path's shapes."""
    import ctypes

    from super_resolution_tpu_torch.ops.conv3x3 import _lib

    lib = _lib()
    plans = {}
    for cout, cin, out_bf16 in PLAN_SHAPES:
        plan = (ctypes.c_int * 5)()
        if lib.conv3x3_wgmma_plan(cout, cin, out_bf16, plan) != 0:
            fail(f"no plan of the Hopper tile for {cin} -> {cout}")
        plans[f"{cin}->{cout}"] = dict(zip(
            ("n", "k_chunk", "stages", "weights_resident", "smem_bytes"),
            list(plan)))
    return "[build] plans " + json.dumps(plans)


def tile_checks_phase():
    """The Hopper tile's load path: TMA's zero fill for the halo and the
    cut at cin, the ragged edge, channel slices, the 256-channel upconv."""
    import importlib

    import torch

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
    from super_resolution_tpu_torch.ops.dense_block import (
        dense_block_plain,
        pack_weight,
    )

    def conv_inputs(shape, cout, seed):
        gen = torch.Generator().manual_seed(seed)
        cin = shape[-1]
        x = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
        w = pack_weight(torch.randn(cout, cin, 3, 3, generator=gen)
                        * math.sqrt(2.0 / (9 * cin))).to("cuda",
                                                         torch.bfloat16)
        return x, w, (torch.randn(cout, generator=gen) * 0.1).cuda()

    def close(got, want, tol):
        atol, rtol = tol
        diff = (got.float() - want.float()).abs()
        return (bool(torch.isfinite(got.float()).all())
                and (diff - rtol * want.float().abs()).max().item() <= atol,
                diff.max().item())

    class Uncounted:        # checks are not the main path
        launches = 0

    # the module (the package's ops exports a function of the same name)
    db_ops = importlib.import_module(
        "super_resolution_tpu_torch.ops.dense_block")

    results = {}
    with torch.inference_mode(), no_tf32():
        for name, shape, growth, nhwc in (
                ("poison_flagship", (8, 64, 128, 128), 32, False),
                ("poison_odd", (2, 64, 37, 53), 32, False),
                ("poison_nhwc_odd", (1, 64, 21, 19), 32, True)):
            x, ws, _, bs = make_block(shape, growth, torch.bfloat16,
                                      500 + len(results))
            x_nhwc = x.permute(0, 2, 3, 1)
            y, buf = db_ops._launch_block(
                Uncounted, x_nhwc.contiguous() if nhwc else x, x_nhwc, ws,
                bs, 0.2, 0.2, nhwc=nhwc, poison=True)
            torch.cuda.synchronize()
            ref = dense_block_plain(x, ws, bs, res_scale=0.2, slope=0.2)
            ok, err = close(y, ref.permute(0, 2, 3, 1) if nhwc else ref,
                            TOL["bfloat16"])
            ok = ok and bool(torch.isfinite(buf.float()).all())
            results[name] = dict(shape=list(shape), nhwc=nhwc, ok=ok,
                                 max_abs_err=err)
        # a prefix of one buffer into a slice of another
        src, w, b = conv_inputs((2, 37, 53, 96), 32, 510)
        gen = torch.Generator().manual_seed(511)
        dst = torch.randn(2, 37, 53, 128, generator=gen).to(
            "cuda", torch.bfloat16)
        src0, dst0 = src.clone(), dst.clone()
        conv3x3(src[..., :64], w[..., :64].contiguous(), b, act=True,
                slope=0.2, out=dst[..., 40:72])
        torch.cuda.synchronize()
        want = conv3x3_plain(src[..., :64], w[..., :64].contiguous(), b,
                             act=True, slope=0.2)
        ok, err = close(dst[..., 40:72], want, CONV_TOL["bfloat16"])
        ok = (ok and torch.equal(src, src0)
              and torch.equal(dst[..., :40], dst0[..., :40])
              and torch.equal(dst[..., 72:], dst0[..., 72:]))
        results["prefix_into_slice"] = dict(ok=ok, max_abs_err=err)
        for name, shape, cout in (("ragged_tail", (2, 37, 53, 64), 64),
                                  ("ragged_small", (1, 7, 9, 64), 32),
                                  ("ragged_conv5", (1, 29, 45, 192), 64),
                                  ("upconv_256", (8, 128, 128, 64), 256),
                                  ("upconv_256_ragged", (1, 35, 30, 64),
                                   256)):
            x, w, b = conv_inputs(shape, cout, 520 + len(results))
            y = conv3x3(x, w, b, act=True, slope=0.2)
            torch.cuda.synchronize()
            ok, err = close(y, conv3x3_plain(x, w, b, act=True, slope=0.2),
                            CONV_TOL["bfloat16"])
            results[name] = dict(shape=list(shape), cout=cout, ok=ok,
                                 max_abs_err=err)
    print("[tile-checks] " + json.dumps(results), flush=True)
    bad = [k for k, v in results.items() if not v["ok"]]
    if bad:
        fail(f"Hopper tile checks failed: {bad}")
    return results


def kernel_phase():
    import torch

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.dense_block import (
        dense_block,
        dense_block_plain,
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
        ("train", TRAIN_SHAPE, 32, "bfloat16", 0.2),
    ]
    results = {}
    for name, shape, growth, dtype_name, slope in cases:
        dtype = getattr(torch, dtype_name)
        b, c, h, w = shape
        x, ws, ws_oihw, bs = make_block(shape, growth, dtype, len(results))
        kw = dict(res_scale=0.2, slope=slope)

        def kernel():
            return dense_block(x, ws, bs, **kw)

        def plain():
            return dense_block_plain(x, ws, bs, **kw)

        def library():
            return cudnn_block(x, ws_oihw, bs, slope)

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
            ms = turns({"plain": plain, "kernel": kernel,
                        "library": library},
                       20 if h * w * b >= 1 << 16 else 50)
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


def bwd_bound(shape, growth, dtype_name, n=5):
    """(bound_ms, bound_by, flops, bytes) of one n-conv dense block's
    backward: twice the forward's operations (a data and a weight product
    per conv); the saved feature buffer (x and x_1..x_{n-1}, unpadded),
    the cotangent and the weights read once, dx, dW (f32) and db written
    once."""
    b, c, h, w = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    _, _, fwd_flops, _ = block_bound(shape, growth, dtype_name, n)
    convs = block_convs(c, growth, n)
    n_w = sum(9 * cin * cout for cin, cout in convs)
    n_b = sum(cout for _, cout in convs)
    pix = b * h * w
    nbytes = (pix * (c + (n - 1) * growth) * elt   # feature buffer
              + 2 * pix * c * elt               # g in, dx out
              + n_w * elt                       # weights in
              + (n_w + n_b) * 4)                # dW, db out
    flops = 2 * fwd_flops
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def bwd_kernel_phase():
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.dense_block import (
        bwd_launches,
        dense_block,
        dense_block_bwd,
        plain_backward,
    )

    cases = [  # name, (B, C, H, W), growth, dtype, slope
        ("train", TRAIN_SHAPE, 32, "bfloat16", 0.2),
        ("odd_fp32", (1, 64, 37, 53), 32, "float32", 0.2),
        ("growth64", (2, 64, 96, 80), 64, "bfloat16", 0.01),
        ("narrow", (2, 16, 40, 72), 8, "bfloat16", 0.2),
        ("w6", (16, 64, 48, 6), 32, "bfloat16", 0.2),
    ]
    results = {}
    for name, shape, growth, dtype_name, slope in cases:
        dtype = getattr(torch, dtype_name)
        x, ws, ws_oihw, bs = make_block(shape, growth, dtype,
                                        100 + len(results))
        g = torch.randn(shape, generator=torch.Generator().manual_seed(
            200 + len(results))).to("cuda", dtype)
        kw = dict(res_scale=0.2, slope=slope)

        def rel(got, want):
            want = want.float()
            return ((got.float() - want).abs().max()
                    / want.abs().max().clamp_min(1e-30)).item()

        with no_tf32():
            with torch.no_grad():
                _, feats = dense_block(x, ws, bs, save_acts=True, **kw)
                before = dense_block_bwd.launches
                dx, dws, dbs = dense_block_bwd(feats, ws, g, **kw)
                torch.cuda.synchronize()
                launches = dense_block_bwd.launches - before
                if launches != bwd_launches(5, dtype):
                    fail(f"{name}: one backward counted {launches} "
                         f"launches (want {bwd_launches(5, dtype)})")
                rx, rws, rbs = plain_backward(feats, ws, g, **kw)
                dx2, dws2, dbs2 = dense_block_bwd(feats, ws, g, **kw)
                torch.cuda.synchronize()
            repeats = torch.equal(dx, dx2) and all(
                torch.equal(a, b_) for a, b_ in zip(dws + dbs, dws2 + dbs2))
            err = dict(dx=rel(dx, rx),
                       dw=[rel(a, b_) for a, b_ in zip(dws, rws)],
                       db=[rel(a, b_) for a, b_ in zip(dbs, rbs)])
            max_abs = (dx.float() - rx.float()).abs().max().item()
            finite = all(bool(torch.isfinite(t.float()).all())
                         for t in (dx, *dws, *dbs))
            tol = BWD_TOL[dtype_name]
            ok = (finite and dx.dtype == dtype and dx.shape == x.shape
                  and err["dx"] <= tol["dx"]
                  and max(err["dw"]) <= tol["dw"]
                  and max(err["db"]) <= tol["db"])

            # the library yardstick: autograd through five cuDNN convs
            # and torch.cat in the working dtype, backward only (the
            # graph is built once and kept); never called by the port
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (x, *ws_oihw, *(bk.to(dtype) for bk in bs))]
            f_ = leaves[0]
            for k in range(4):
                o = F.leaky_relu(F.conv2d(f_, leaves[1 + k], leaves[6 + k],
                                          padding=1), slope)
                f_ = torch.cat([f_, o], 1)
            y_lib = leaves[0] + 0.2 * F.conv2d(f_, leaves[5], leaves[10],
                                               padding=1)

            def kernel():
                return dense_block_bwd(feats, ws, g, **kw)

            def plain():
                return plain_backward(feats, ws, g, **kw)

            def library():
                return torch.autograd.grad(y_lib, leaves, g,
                                           retain_graph=True)

            with torch.no_grad():
                ms = turns({"plain": plain, "kernel": kernel,
                            "library": library}, 20)
            # the wrapper's time above includes its eager glue and is
            # bound by the host at these sizes; the kernels alone:
            dev_ms = own_device_ms(kernel)
        bound_ms, bound_by, flops, nbytes = bwd_bound(shape, growth,
                                                      dtype_name)
        results[name] = dict(
            shape=list(shape), growth=growth, dtype=dtype_name, slope=slope,
            rel_err=err, tol=tol, max_abs_err=max_abs,
            repeats_bit_for_bit=repeats, ok=ok, launches=launches,
            kernel_ms=ms["kernel"], kernels_device_ms=dev_ms,
            plain_ms=ms["plain"],
            library_ms=ms["library"], bound_ms=bound_ms, bound_by=bound_by,
            flops=flops, bytes=nbytes,
            roofline_share=bound_ms / ms["kernel"],
            tflops=flops / (ms["kernel"] * 1e-3) / 1e12)
        print("[kernel-bwd] " + json.dumps({name: results[name]}),
              flush=True)
        if not ok:
            fail(f"{name}: backward kernels disagree with their plain "
                 f"version: relative errors {err}, tolerances {tol}")
        if not repeats:
            fail(f"{name}: two runs of the backward differ (the two-pass "
                 f"weight gradient should repeat bit for bit)")
    return results


def model_phase():
    import numpy as np
    import torch

    import super_resolution_tpu_torch.models.rrdb as rrdb
    from super_resolution_tpu_torch.config import GeneratorConfig, TrainConfig
    from super_resolution_tpu_torch.ops.dense_block import (
        LAUNCHES_PER_BLOCK,
        dense_block,
    )
    from super_resolution_tpu_torch.train.steps import make_infer_fn

    gcfg = GeneratorConfig(init=SEED_INIT)    # 23 blocks, 64 / 32
    sd = rrdb.RRDBNet(gcfg, torch.Generator().manual_seed(0)).state_dict()
    infer = make_infer_fn(TrainConfig(compute_dtype="bfloat16"), sd, "cuda")
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

    with PlainKernels():
        ref = infer(x)
    rng_ = (ref.max() - ref.min()).item()
    mse = ((out - ref) ** 2).mean().item()
    psnr = 10 * math.log10(rng_ ** 2 / mse) if mse > 0 else float("inf")
    print(f"[model] bf16 kernel vs plain forward: PSNR {psnr:.2f} dB over "
          f"the output range {rng_:.4f} (floor "
          f"{BF16_MODEL_PSNR_FLOOR_DB} dB), max |err| "
          f"{(out - ref).abs().max().item():.6g}", flush=True)
    if not psnr >= BF16_MODEL_PSNR_FLOOR_DB:
        fail(f"bf16 model PSNR {psnr} dB below the floor")

    infer32 = make_infer_fn(TrainConfig(compute_dtype="float32"), sd, "cuda")
    x32 = x[:2, :64, :64].contiguous()
    out32 = infer32(x32)
    with PlainKernels():
        ref32 = infer32(x32)
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
    profile_device(lambda: infer(x), ms, "profile")
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


# names of the port's own kernels in a profile (csrc/*.cu)
OWN_KERNELS = ("conv3x3_", "dgrad3x3", "wgrad3x3", "wgrad_reduce",
               "wgrad_wgmma", "bwd_prep", "bwd_reduce", "conv_int8",
               "int8_prep", "int8_band")
# v8's kernels (csrc/dense_block_int8.cu), by name in a profile
INT8_KERNELS = ("int8_prep_weights", "int8_band", "conv_int8_wgmma")
# the bf16 backward's kernels (csrc/dense_block_bwd.cu): its data
# gradient is the Hopper tile's conv3x3_wgmma with the backward epilogues
# (template <N, K chunk, float, true>)
BWD_KERNELS = {"dgrad_gather": "float, true>", "wgrad_wgmma": "wgrad_wgmma",
               "bwd_prep": "bwd_prep", "bwd_reduce": "bwd_reduce"}


def device_times(fn):
    """(profile, device ms by kernel name) of one call of ``fn`` under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        # kernels and copies only: an annotation carried over to the
        # device (Optimizer.step#Adam.step) spans its kernels and the
        # gaps between them, and would count both twice
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith(("Optimizer.", "ProfilerStep"))):
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return prof, by_name


def own_device_ms(fn, calls: int = 5):
    """Device ms per call that ``fn`` spends in the port's own kernels
    (no host time, no PyTorch glue kernels); None where the profiler
    records no device kernels."""
    def many():
        for _ in range(calls):
            fn()

    _, by_name = device_times(many)
    own = [t for n, t in by_name.items()
           if any(k in n for k in OWN_KERNELS)]
    return sum(own) / calls if own else None


def profile_device(fn, ms, tag):
    """Device time of one call of ``fn`` by kernel, from torch.profiler:
    the share of the port's own kernels and the device's idle share of
    the unprofiled ``ms`` per call.  Prints 'not measured' where the
    profiler records no device kernels."""
    prof, by_name = device_times(fn)
    if not by_name:
        print(f"[{tag}] device time by kernel: not measured (the profiler "
              "recorded no CUDA kernels)", flush=True)
        return
    busy = sum(by_name.values())
    dense = sum(t for n, t in by_name.items()
                if any(k in n for k in OWN_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[{tag}] " + json.dumps({
        "device_busy_ms": busy, "dense_block_kernel_ms": dense,
        "dense_block_share_of_busy": dense / busy,
        "idle_share_of_batch": max(0.0, 1 - busy / ms),
        "own_kernels_ms": {
            n.split("(anonymous namespace)::")[1].split("(")[0]: t
            for n, t in sorted(by_name.items())
            if any(k in n for k in OWN_KERNELS)},
        "bwd_kernels_ms": {
            k: sum(t for n, t in by_name.items() if pat in n)
            for k, pat in BWD_KERNELS.items()},
        "top_kernels_ms": {n[:90]: t for n, t in top},
        # where the host spends the call (under the profiler, which
        # slows the host: read the order, not the sizes)
        "top_host_ops_self_ms": {
            a.key[:60]: a.self_cpu_time_total / 1e3
            for a in sorted(prof.key_averages(),
                            key=lambda a: -a.self_cpu_time_total)[:10]},
        "host_ops": sum(a.count for a in prof.key_averages()
                        if a.key.startswith("aten::")),
        "kernel_launches": sum(a.count for a in prof.key_averages()
                               if a.key == "cudaLaunchKernel")}),
        flush=True)


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
        sd_serve = torch.load(pth, weights_only=True)
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
        with PlainKernels():
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
    # the frame, its checkpoint and its upscale, for the impls phase
    return res, dict(lr=frames["a"], sd=sd_serve, sr=sr)


def launch_counters():
    """Kernel name -> the wrapper that counts its launches."""
    import importlib

    db = importlib.import_module("super_resolution_tpu_torch.ops.dense_block")
    c3 = importlib.import_module("super_resolution_tpu_torch.ops.conv3x3")
    ex = importlib.import_module(
        "super_resolution_tpu_torch.ops.experiments_dense_block")
    return {"dense_block": db.dense_block, "dense_block_bwd":
            db.dense_block_bwd, "dense_block_nhwc": db.fused_dense_block,
            "conv3x3": c3.conv3x3,
            **{f.__name__: f for f in (
                ex.fused_dense_block_cf, ex.fused_dense_block_cf2,
                ex.fused_dense_block_cf3, ex.fused_dense_block_cf6,
                ex.fused_dense_block_cf8)}}


def cli_train_recorded(argv):
    """``cli.main(argv)`` of a ``train`` command with every step the loop
    builds wrapped to time it and keep its metrics and the launches it
    made (the loop logs windowed means).  Every count is set to 0 just
    before the run.  Returns (rc, per-step records, launches over the
    run by kernel)."""
    import torch

    import super_resolution_tpu_torch.train.loop as loop
    from super_resolution_tpu_torch import cli

    counters = launch_counters()
    records = []

    def recording(make, kind):
        def wrapped(step_cfg):
            step = make(step_cfg)

            def timed(state, batch):
                torch.cuda.synchronize()
                before = {n: f.launches for n, f in counters.items()}
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                metrics = step(state, batch)
                torch.cuda.synchronize()
                n = {k: f.launches - before[k] for k, f in counters.items()}
                records.append(dict(
                    kind=kind, ms=(time.perf_counter() - t0) * 1e3,
                    fwd=n["dense_block"], bwd=n["dense_block_bwd"],
                    conv3x3=n["conv3x3"],
                    peak_bytes=torch.cuda.max_memory_allocated(),
                    metrics={k: float(v) for k, v in metrics.items()}))
                return metrics

            return timed

        return wrapped

    orig_makers = loop.make_pretrain_step, loop.make_gan_step
    loop.make_pretrain_step = recording(orig_makers[0], "warmup")
    loop.make_gan_step = recording(orig_makers[1], "gan")
    for f in counters.values():
        f.launches = 0
    try:
        rc = cli.main(argv)
    finally:
        loop.make_pretrain_step, loop.make_gan_step = orig_makers
    return rc, records, {n: f.launches for n, f in counters.items()}


def train_phase():
    import dataclasses
    import importlib
    import statistics

    import numpy as np
    import torch
    from PIL import Image

    from super_resolution_tpu_torch import cli
    from super_resolution_tpu_torch.checkpoint import restore_checkpoint
    from super_resolution_tpu_torch.config import preset
    from super_resolution_tpu_torch.data import (
        SyntheticPatches,
        preprocess_batch,
    )
    from super_resolution_tpu_torch.train.state import init_state
    from super_resolution_tpu_torch.train.steps import (
        make_gan_step,
        make_pretrain_step,
    )

    # the module (the package's ``ops`` exports a function of its name)
    ops = importlib.import_module(
        "super_resolution_tpu_torch.ops.dense_block")
    cfg = preset("train_gan_dfm")      # 23 blocks, 64 / 32, bf16, batch 16
    gcfg = cfg.generator
    n_blocks = gcfg.n_blocks * gcfg.n_dense
    want_fwd = n_blocks * ops.LAUNCHES_PER_BLOCK
    want_bwd = n_blocks * ops.BWD_LAUNCHES_PER_BLOCK
    n_warmup, n_steps = 3, 6

    def swapped(fn):
        """Run ``fn`` with the dense block's forward and backward
        replaced by their plain versions."""
        orig = ops.dense_block, ops.dense_block_bwd
        ops.dense_block, ops.dense_block_bwd = \
            ops.plain_forward, ops.plain_backward
        try:
            return fn()
        finally:
            ops.dense_block, ops.dense_block_bwd = orig

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def worst_grad(state_a, state_b):
        """(delta over the tensor's largest value, name) of the gradient
        tensor of G that differs most between two states."""
        return max(
            (float((pa.grad - pb.grad).abs().max()
                   / pb.grad.abs().max().clamp_min(1e-30)), name)
            for (name, pa), pb in zip(state_a.g.named_parameters(),
                                      state_b.g.parameters()))

    with tempfile.TemporaryDirectory() as tmp:
        ck, log = os.path.join(tmp, "ck"), os.path.join(tmp, "log")
        rc, records, totals = cli_train_recorded(
            ["train", "--preset", "train_gan_dfm",
             "--dataset_dir", os.path.join(tmp, "no_dataset"),
             "--steps", str(n_steps), "--warmup_batches",
             str(n_warmup), "--checkpoint_dir", ck, "--log_dir", log])
        fwd_launches = totals["dense_block"]
        bwd_launches = totals["dense_block_bwd"]
        if rc != 0:
            fail(f"cli train returned {rc}")
        for i, r in enumerate(records):
            print(f"[train] step {i + 1} " + json.dumps(r), flush=True)
        kinds = [r["kind"] for r in records]
        if kinds != ["warmup"] * n_warmup + ["gan"] * (n_steps - n_warmup):
            fail(f"steps ran as {kinds}")
        print(f"[train] dense-block launches per generator update: forward "
              f"{sorted({r['fwd'] for r in records})} (want {n_blocks} "
              f"blocks x {ops.LAUNCHES_PER_BLOCK} = {want_fwd}), backward "
              f"{sorted({r['bwd'] for r in records})} (want {n_blocks} x "
              f"{ops.BWD_LAUNCHES_PER_BLOCK} = {want_bwd}); over "
              f"{n_steps} steps {fwd_launches} and {bwd_launches}",
              flush=True)
        if any(r["fwd"] != want_fwd or r["bwd"] != want_bwd
               for r in records) or fwd_launches != n_steps * want_fwd \
                or bwd_launches != n_steps * want_bwd:
            fail("the training path did not launch the forward kernel once "
                 "per conv and the backward kernels three times per conv "
                 "of every dense block of every generator update")
        for i, r in enumerate(records):
            bad = [k for k, v in r["metrics"].items() if not math.isfinite(v)]
            if bad:
                fail(f"step {i + 1}: metrics {bad} are not finite")
        gan_names = {"loss_pixel", "loss_adv", "loss_percep", "loss_g",
                     "loss_d", "psnr", "grad_norm_g", "grad_norm_d"}
        if set(records[-1]["metrics"]) != gan_names:
            fail(f"GAN step metrics {sorted(records[-1]['metrics'])}")
        first, third = (records[i]["metrics"]["loss_pixel"] for i in (0, 2))
        print(f"[train] warmup loss_pixel: step 1 {first:.6f}, step 3 "
              f"{third:.6f}", flush=True)
        if not third < first:
            fail("the warmup loss did not fall over three steps")

        tree = torch.load(os.path.join(ck, str(n_steps), "state.pt"),
                          map_location="cpu", weights_only=True)
        ema_gap = max(float((tree["g_ema"][k] - v).abs().max())
                      for k, v in tree["g"].items())
        print(f"[train] checkpoint step {tree['step']}; max |EMA - "
              f"parameter| {ema_gap:.3g}", flush=True)
        if tree["step"] != n_steps or not ema_gap > 0:
            fail("the checkpoint's step or EMA is wrong")

        # the checkpoint in cli upscale
        rng = np.random.default_rng(2)
        src, dst = os.path.join(tmp, "lr.png"), os.path.join(tmp, "sr.png")
        Image.fromarray(rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)) \
            .save(src)
        rc = cli.main(["upscale", "--image", src, "--checkpoint", ck,
                       "--out", dst])
        with Image.open(dst) as im:
            if rc != 0 or im.size != (512, 384):
                fail(f"cli upscale from the train checkpoint: rc {rc}, "
                     f"size {im.size}")

        # one more step of each kind from the checkpoint: kernels vs plain
        batch = torch.from_numpy(
            next(iter(SyntheticPatches(cfg.data, seed=123)))).cuda()
        pair = preprocess_batch(batch, cfg.data, augment=False)
        gan = make_gan_step(cfg)

        def restored():
            states = {}
            for which in ("kernel", "plain"):
                states[which], _, at = restore_checkpoint(
                    ck, init_state(cfg, "cuda"))
                if at != n_steps:
                    fail(f"restore_checkpoint gave step {at}")
            return states

        states = restored()
        pre = make_pretrain_step(cfg)
        w_k = pre.core(states["kernel"], pair["lr"], pair["hr"])
        w_p = swapped(lambda: pre.core(states["plain"], pair["lr"],
                                       pair["hr"]))
        w_deltas = {k: rel(float(w_k[k]), float(v)) for k, v in w_p.items()}
        w_grad, w_name = worst_grad(states["kernel"], states["plain"])
        print("[train] warmup step, kernels vs plain dense block (bf16, "
              f"full width): relative deltas {json.dumps(w_deltas)} "
              f"(limits: loss {STEP_LOSS_RTOL}, grad_norm_g "
              f"{STEP_GRAD_NORM_RTOL}); worst gradient tensor of G "
              f"({w_name}): {w_grad:.4g} of its largest value (limit "
              f"{STEP_WARMUP_GRAD_TOL})", flush=True)
        if not w_deltas["loss_pixel"] <= STEP_LOSS_RTOL \
                or not w_deltas["grad_norm_g"] <= STEP_GRAD_NORM_RTOL \
                or not w_grad <= STEP_WARMUP_GRAD_TOL:
            fail("the warmup step through the kernels differs from the "
                 "plain dense block")
        states = restored()
        m_k = gan.core(states["kernel"], pair["lr"], pair["hr"])
        f0 = ops.dense_block.launches
        m_p = swapped(lambda: gan.core(states["plain"], pair["lr"],
                                       pair["hr"]))
        torch.cuda.synchronize()
        if ops.dense_block.launches != f0:
            fail("the plain step launched the kernel")
        m_k = {k: float(v) for k, v in m_k.items()}
        m_p = {k: float(v) for k, v in m_p.items()}
        deltas = {k: rel(m_k[k], m_p[k]) for k in m_p}
        grad_rel, grad_name = worst_grad(states["kernel"], states["plain"])
        print("[train] GAN step, kernels vs plain dense block (bf16, full "
              f"width): relative deltas {json.dumps(deltas)} (limits: "
              f"losses {STEP_LOSS_RTOL}, grad_norm_g {STEP_GRAD_NORM_RTOL}"
              f"); worst gradient tensor of G ({grad_name}), against its "
              f"largest value, not held: {grad_rel:.4g}", flush=True)
        for k, d in deltas.items():
            limit = STEP_GRAD_NORM_RTOL if k.startswith("grad_norm") \
                else STEP_LOSS_RTOL
            if not d <= limit:
                fail(f"GAN step through the kernels differs from the plain "
                     f"dense block in {k}: {m_k[k]} vs {m_p[k]}")

        # device profile of one GAN step, from the kernel state
        gan_ms = statistics.median(
            r["ms"] for r in records[n_warmup + 1:])
        warm_ms = statistics.median(r["ms"] for r in records[1:n_warmup])
        profile_device(lambda: gan.core(states["kernel"], pair["lr"],
                                        pair["hr"]), gan_ms, "train-profile")
        del states

    # float32, small geometry: every gradient tensor of G
    cfg32 = dataclasses.replace(
        cfg, compute_dtype="float32",
        generator=dataclasses.replace(gcfg, n_blocks=2,
                                      init="torch_default"),
        data=dataclasses.replace(cfg.data, hr_patch=48, batch_size=2))
    gen = torch.Generator().manual_seed(7)
    lr32 = torch.randn(2, 12, 12, 3, generator=gen).cuda()
    hr32 = torch.randn(2, 48, 48, 3, generator=gen).cuda()
    gan32 = make_gan_step(cfg32)
    out = {}
    for which in ("kernel", "plain"):
        state = init_state(cfg32, "cuda")
        with torch.no_grad():
            # a freshly drawn G gives an almost constant SR image, on
            # which D's batch statistics cancel catastrophically and
            # amplify summation-order noise; scaled, SR varies like HR
            state.g.conv_last.weight.mul_(30.0)
            state.g.conv_last.bias.mul_(30.0)
        run = (lambda: gan32.core(state, lr32, hr32))
        metrics = run() if which == "kernel" else swapped(run)
        out[which] = ({k: float(v) for k, v in metrics.items()},
                      [p.grad.clone() for p in state.g.parameters()])
    worst32 = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(out["kernel"][1], out["plain"][1]))
    loss32 = max(rel(out["kernel"][0][k], v)
                 for k, v in out["plain"][0].items())
    print(f"[train] fp32 GAN step (2 blocks, 2x48x48 HR), kernels vs plain: "
          f"worst gradient tensor {worst32:.4g} of its largest value "
          f"(limit {STEP_FP32_GRAD_TOL}), worst metric {loss32:.4g} "
          f"relative", flush=True)
    if not worst32 <= STEP_FP32_GRAD_TOL or not loss32 <= STEP_FP32_GRAD_TOL:
        fail("the fp32 GAN step through the kernels differs from the plain "
             "dense block")

    b, hp = cfg.data.batch_size, cfg.data.hr_patch
    mp = b * hp * hp / 1e6
    peak = max(r["peak_bytes"] for r in records[n_warmup:])
    res = dict(fwd_launches=fwd_launches, bwd_launches=bwd_launches,
               fwd_per_update=want_fwd, bwd_per_update=want_bwd,
               warmup_step_ms=warm_ms, gan_step_ms=gan_ms,
               warmup_mp_per_s=mp / (warm_ms / 1e3),
               gan_mp_per_s=mp / (gan_ms / 1e3),
               first_step_ms=records[0]["ms"],
               first_gan_step_ms=records[n_warmup]["ms"],
               peak_memory_gb=peak / 1e9,
               kernel_vs_plain=deltas, kernel_vs_plain_grad=grad_rel,
               warmup_kernel_vs_plain=w_deltas,
               warmup_kernel_vs_plain_grad=w_grad)
    print(f"[train] {b} x {hp}x{hp} HR patches, bf16, 23 blocks: "
          f"{warm_ms:.3f} ms per warmup step, {gan_ms:.3f} ms per GAN step "
          f"(medians of the steps after the first of each kind), "
          f"{res['gan_mp_per_s']:.3f} HR MP/s in GAN steps; peak memory of "
          f"a GAN step {res['peak_memory_gb']:.3f} GB", flush=True)
    print("[train] " + json.dumps(res), flush=True)
    return res


def conv_bound(shape, cout, dtype_name, out_elt=None):
    """(bound_ms, bound_by, flops, bytes) of one 3x3 conv on NHWC
    ``shape``: x, weights and bias read once, y written once."""
    b, h, w, cin = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    out_elt = out_elt or elt
    flops = 2 * b * h * w * 9 * cin * cout
    nbytes = (b * h * w * (cin * elt + cout * out_elt)
              + 9 * cin * cout * elt + 4 * cout)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def turns(fns, iters):
    """ms per call of each of ``fns`` (name -> fn), timed in turns
    (plain, kernel, library, library, kernel, plain) after a warm-up."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for label in ("plain", "kernel", "library", "library", "kernel",
                  "plain"):
        times[label].append(time_ms(fns[label], iters))
    return {k: sum(v) / len(v) for k, v in times.items()}


def conv3x3_phase():
    """The single-conv kernel against its plain version at the shapes
    of the tail (conv_impl pallas_cf_tail) and of conv_first / conv_last
    (conv_impl pallas), flagship batch 8 of 128x128 LR tiles."""
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.conv3x3 import (
        conv3x3,
        conv3x3_cf,
        conv3x3_plain,
    )
    from super_resolution_tpu_torch.ops.dense_block import (
        pack_weight,
        unpack_weight,
    )

    cases = [  # name, NHWC x, cout, dtype, LeakyReLU
        ("conv_body_128", (8, 128, 128, 64), 64, "bfloat16", False),
        ("upconv1_256", (8, 256, 256, 64), 64, "bfloat16", True),
        ("hr_conv_512", (8, 512, 512, 64), 64, "bfloat16", True),
        ("conv_first", (8, 128, 128, 3), 64, "bfloat16", False),
        ("conv_last", (8, 512, 512, 64), 3, "bfloat16", False),
        ("upconv_ps", (8, 128, 128, 64), 256, "bfloat16", True),
        ("odd_fp32", (1, 37, 53, 64), 64, "float32", True),
    ]
    results = {}
    for name, shape, cout, dtype_name, act in cases:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator().manual_seed(300 + len(results))
        cin = shape[-1]
        x = torch.randn(shape, generator=gen).to("cuda", dtype)
        w = pack_weight(torch.randn(cout, cin, 3, 3, generator=gen)
                        * math.sqrt(2.0 / (9 * cin))).to("cuda", dtype)
        b = (torch.randn(cout, generator=gen) * 0.1).cuda()
        w_oihw, b_lib = unpack_weight(w).contiguous(), b.to(dtype)
        x_cl = x.permute(0, 3, 1, 2)          # NCHW view, channels-last
        kw = dict(act=act, slope=0.2)

        fns = {"kernel": lambda: conv3x3(x, w, b, **kw),
               "plain": lambda: conv3x3_plain(x, w, b, **kw),
               # one cuDNN conv with its bias in the working dtype (no
               # activation): a yardstick of speed only
               "library": lambda: F.conv2d(x_cl, w_oihw, b_lib, padding=1)}
        with torch.inference_mode(), no_tf32():
            y = fns["kernel"]()
            torch.cuda.synchronize()
            ref = fns["plain"]()
            diff = (y.float() - ref.float()).abs()
            atol, rtol = CONV_TOL[dtype_name]
            ok = (y.shape == ref.shape and y.dtype == ref.dtype
                  and bool(torch.isfinite(y.float()).all())
                  and (diff - rtol * ref.float().abs()).max().item() <= atol)
            ms = turns(fns, 10 if shape[1] >= 512 else 20)
            extra = {}
            if name == "conv_body_128":
                # conv3x3_cf's one conversion of a contiguous NCHW input
                nchw = x_cl.contiguous()
                extra["cf_nchw_input_ms"] = time_ms(
                    lambda: conv3x3_cf(nchw, w, b, **kw), 20)
                extra["cf_channels_last_input_ms"] = time_ms(
                    lambda: conv3x3_cf(x_cl, w, b, **kw), 20)
        bound_ms, bound_by, flops, nbytes = conv_bound(shape, cout,
                                                       dtype_name)
        results[name] = dict(
            shape=list(shape), cout=cout, dtype=dtype_name, act=act,
            max_abs_err=diff.max().item(), atol=atol, rtol=rtol, ok=ok,
            kernel_ms=ms["kernel"], plain_ms=ms["plain"],
            library_ms=ms["library"], bound_ms=bound_ms, bound_by=bound_by,
            flops=flops, bytes=nbytes, roofline_share=bound_ms / ms["kernel"],
            tflops=flops / (ms["kernel"] * 1e-3) / 1e12, **extra)
        print("[kernel-conv3x3] " + json.dumps({name: results[name]}),
              flush=True)
        if not ok:
            fail(f"conv3x3 {name}: kernel disagrees with its plain version "
                 f"(max |err| {diff.max().item()}, tolerance atol {atol} + "
                 f"rtol {rtol}·|plain|)")
    return results


def fused_phase():
    """The NHWC dense-block entry against its plain version."""
    import torch

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.dense_block import (
        fused_dense_block,
        fused_dense_block_plain,
    )

    cases = [("flagship", (8, 64, 128, 128), "bfloat16"),
             ("odd_fp32", (1, 64, 37, 53), "float32")]
    results = {}
    for name, shape, dtype_name in cases:
        dtype = getattr(torch, dtype_name)
        x, ws, ws_oihw, bs = make_block(shape, 32, dtype, 400 + len(results))
        x = x.permute(0, 2, 3, 1).contiguous()           # NHWC
        x_cl = x.permute(0, 3, 1, 2)
        kw = dict(res_scale=0.2, slope=0.2)
        fns = {"kernel": lambda: fused_dense_block(x, ws, bs, **kw),
               "plain": lambda: fused_dense_block_plain(x, ws, bs, **kw),
               # on the channels-last view
               "library": lambda: cudnn_block(x_cl, ws_oihw, bs)}
        with torch.inference_mode(), no_tf32():
            y = fns["kernel"]()
            torch.cuda.synchronize()
            ref = fns["plain"]()
            diff = (y.float() - ref.float()).abs()
            atol, rtol = TOL[dtype_name]
            ok = (y.shape == ref.shape == x.shape and y.is_contiguous()
                  and bool(torch.isfinite(y.float()).all())
                  and (diff - rtol * ref.float().abs()).max().item() <= atol)
            ms = turns(fns, 20)
        bound_ms, bound_by, flops, nbytes = block_bound(shape, 32,
                                                        dtype_name)
        results[name] = dict(
            shape_nhwc=list(x.shape), dtype=dtype_name,
            max_abs_err=diff.max().item(), atol=atol, rtol=rtol, ok=ok,
            kernel_ms=ms["kernel"], plain_ms=ms["plain"],
            library_ms=ms["library"], bound_ms=bound_ms, bound_by=bound_by,
            roofline_share=bound_ms / ms["kernel"])
        print("[kernel-fused] " + json.dumps({name: results[name]}),
              flush=True)
        if not ok:
            fail(f"NHWC dense block {name}: kernel disagrees with its plain "
                 f"version (max |err| {diff.max().item()})")
    return results


def per_forward_launches(impl, gcfg):
    """Launches of one generator forward under ``impl``, by kernel."""
    n = gcfg.n_blocks * gcfg.n_dense * 5
    tail = 2 + gcfg.n_upsample              # conv_body, upconvs, conv_hr
    return {"pallas_cf_tail": dict(dense_block=n, conv3x3=tail),
            "pallas": dict(conv3x3=n + tail + 2),   # + conv_first, conv_last
            "pallas_fused": dict(dense_block_nhwc=n),
            "lax": {}}[impl]                        # cuDNN only


class PlainKernels:
    """Every kernel wrapper the model calls replaced by its plain version
    while the block runs."""

    def __enter__(self):
        import importlib

        import super_resolution_tpu_torch.models.rrdb as rrdb

        self.c3 = importlib.import_module(
            "super_resolution_tpu_torch.ops.conv3x3")
        db = importlib.import_module(
            "super_resolution_tpu_torch.ops.dense_block")
        self.rrdb = rrdb
        self.orig = (rrdb.dense_block, rrdb.fused_dense_block,
                     self.c3.conv3x3)
        rrdb.dense_block = db.dense_block_plain
        rrdb.fused_dense_block = db.fused_dense_block_plain
        self.c3.conv3x3 = self.c3.conv3x3_plain
        return self

    def __exit__(self, *exc):
        (self.rrdb.dense_block, self.rrdb.fused_dense_block,
         self.c3.conv3x3) = self.orig


IMPLS = ("pallas_cf_tail", "pallas", "pallas_fused", "lax")


def impls_phase(frame):
    """The flagship forward under each of the four further conv impls,
    then ``cli upscale --conv_impl X`` of the serve phase's frame
    (``frame``: its RGBA pixels, checkpoint and default-impl upscale).
    Under ``lax`` the plain reference is the same cuDNN forward."""
    import numpy as np
    import torch
    from PIL import Image

    import super_resolution_tpu_torch.models.rrdb as rrdb
    from super_resolution_tpu_torch import cli
    from super_resolution_tpu_torch.config import GeneratorConfig, TrainConfig
    from super_resolution_tpu_torch.ops.conv3x3 import conv3x3_cf
    from super_resolution_tpu_torch.parallel.tiling import plan_tiles
    from super_resolution_tpu_torch.train.steps import make_infer_fn

    counters = launch_counters()
    sd = rrdb.RRDBNet(GeneratorConfig(init=SEED_INIT),
                      torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 128, 128, 3))
                         .astype(np.float32)).cuda()
    results = {}
    for impl in IMPLS:
        gcfg = GeneratorConfig(init=SEED_INIT, conv_impl=impl)
        infer = make_infer_fn(TrainConfig(compute_dtype="bfloat16",
                                          generator=gcfg), sd, "cuda")
        infer(x)                                  # warm-up
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        conv3x3_cf.conversions = 0
        out = infer(x)
        torch.cuda.synchronize()
        got = {n: f.launches for n, f in counters.items() if f.launches}
        conversions = conv3x3_cf.conversions
        want = per_forward_launches(impl, gcfg)
        with PlainKernels():
            ref = infer(x)
        rng_ = (ref.max() - ref.min()).item()
        mse = ((out - ref) ** 2).mean().item()
        psnr = 10 * math.log10(rng_ ** 2 / mse) if mse > 0 else float("inf")
        times = [time_ms(lambda: infer(x), 5) for _ in range(3)]
        ms = sorted(times)[1]
        results[impl] = dict(
            launches=got, want=want, nchw_conversions=conversions,
            psnr_db=psnr, max_abs_err=(out - ref).abs().max().item(),
            ms=ms, ms_runs=times, mp_per_s=8 * 512 * 512 / 1e6 / (ms / 1e3))
        print(f"[impls] {impl}: " + json.dumps(results[impl]), flush=True)
        profile_device(lambda: infer(x), ms, f"impls-profile-{impl}")
        if got != want:
            fail(f"{impl}: one forward launched {got}, want {want}")
        if tuple(out.shape) != (8, 512, 512, 3) or \
                not bool(torch.isfinite(out).all()):
            fail(f"{impl}: output {tuple(out.shape)} not finite (8,512,512,3)")
        if not psnr >= BF16_MODEL_PSNR_FLOOR_DB:
            fail(f"{impl}: kernel vs plain forward PSNR {psnr} dB below "
                 f"{BF16_MODEL_PSNR_FLOOR_DB}")
        del infer

    # cli upscale of the serve phase's frame under each impl
    tile, halo, tile_batch = 384, 8, 2
    with tempfile.TemporaryDirectory() as tmp:
        pth, src = os.path.join(tmp, "g.pth"), os.path.join(tmp, "a.png")
        torch.save(frame["sd"], pth)
        Image.fromarray(frame["lr"], "RGBA").save(src)
        h, w = frame["lr"].shape[:2]
        _, oys, oxs = plan_tiles(h, w, tile, halo)
        forwards = math.ceil(len(oys) * len(oxs) / tile_batch)
        auto = frame["sr"].astype(np.int16)
        for impl in IMPLS:
            dst = os.path.join(tmp, f"{impl}.png")
            for f in counters.values():
                f.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(["upscale", "--image", src, "--checkpoint", pth,
                           "--out", dst, "--conv_impl", impl])
            secs = time.perf_counter() - t0
            got = {n: f.launches for n, f in counters.items() if f.launches}
            want = {k: forwards * v for k, v in
                    per_forward_launches(impl, GeneratorConfig()).items()}
            sr = np.asarray(Image.open(dst))
            d = np.abs(sr.astype(np.int16) - auto)
            mse = float((d.astype(np.float64) ** 2).mean())
            psnr = 10 * math.log10(255.0 ** 2 / mse) if mse else float("inf")
            res = dict(rc=rc, s=secs, launches=got, want=want,
                       shape=list(sr.shape), max_lsb_vs_auto=int(d.max()),
                       mean_lsb_vs_auto=float(d.mean()),
                       psnr_db_vs_auto=psnr)
            results[f"cli_{impl}"] = res
            print(f"[impls] cli upscale --conv_impl {impl}: "
                  + json.dumps(res), flush=True)
            if rc != 0 or tuple(sr.shape) != auto.shape or got != want:
                fail(f"cli upscale --conv_impl {impl}: {res}")
            if not np.array_equal(sr[..., 3], frame["sr"][..., 3]):
                fail(f"cli upscale --conv_impl {impl} did not keep alpha")
            if not psnr >= CLI_IMPL_PSNR_FLOOR_DB:
                fail(f"cli upscale --conv_impl {impl} is {psnr} dB from the "
                     f"default path's frame (floor {CLI_IMPL_PSNR_FLOOR_DB})")
    return results


def tail_train_phase():
    """``cli train --preset train_gan_dfm --conv_impl pallas_cf_tail``,
    full width, two warmup and two GAN steps: the dense-block kernels
    forward and backward and the tail kernel in every generator update,
    finite metrics."""
    import importlib

    ops = importlib.import_module(
        "super_resolution_tpu_torch.ops.dense_block")
    from super_resolution_tpu_torch.config import preset

    gcfg = preset("train_gan_dfm").generator
    n_blocks = gcfg.n_blocks * gcfg.n_dense
    want = dict(fwd=n_blocks * ops.LAUNCHES_PER_BLOCK,
                bwd=n_blocks * ops.BWD_LAUNCHES_PER_BLOCK,
                conv3x3=per_forward_launches("pallas_cf_tail",
                                             gcfg)["conv3x3"])
    with tempfile.TemporaryDirectory() as tmp:
        rc, records, totals = cli_train_recorded(
            ["train", "--preset", "train_gan_dfm", "--conv_impl",
             "pallas_cf_tail", "--dataset_dir",
             os.path.join(tmp, "no_dataset"), "--steps", "4",
             "--warmup_batches", "2", "--checkpoint_dir",
             os.path.join(tmp, "ck")])
    for i, r in enumerate(records):
        print(f"[train-tail] step {i + 1} " + json.dumps(r), flush=True)
    print(f"[train-tail] launches per generator update: forward "
          f"{sorted({r['fwd'] for r in records})}, backward "
          f"{sorted({r['bwd'] for r in records})}, tail conv3x3 "
          f"{sorted({r['conv3x3'] for r in records})} (want {want}); over "
          f"the run {totals}", flush=True)
    if rc != 0 or [r["kind"] for r in records] != ["warmup"] * 2 + ["gan"] * 2:
        fail(f"cli train --conv_impl pallas_cf_tail: rc {rc}, steps "
             f"{[r['kind'] for r in records]}")
    if any(r[k] != v for r in records for k, v in want.items()):
        fail("cli train --conv_impl pallas_cf_tail did not launch every "
             "kernel of its path in every generator update")
    for i, r in enumerate(records):
        bad = [k for k, v in r["metrics"].items() if not math.isfinite(v)]
        if bad:
            fail(f"pallas_cf_tail step {i + 1}: metrics {bad} not finite")
    return dict(totals=totals, per_update=want,
                gan_step_ms=records[-1]["ms"], warmup_step_ms=records[1]["ms"])


def hwio_block(shape, growth, dtype, seed):
    """``make_block``'s block with HWIO weights (the experiment kernels'
    contract): x, HWIO weights, packed weights and biases on the card."""
    x, ws, ws_oihw, bs = make_block(shape, growth, dtype, seed)
    return x, [w.permute(2, 3, 1, 0) for w in ws_oihw], ws, ws_oihw, bs


def experiments_phase():
    """v3, v3b, v4 and v6: the dense-block kernel behind their own
    contracts."""
    import torch

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops import experiments_dense_block as ex
    from super_resolution_tpu_torch.ops.dense_block import (
        LAUNCHES_PER_BLOCK,
        dense_block,
    )

    cases = [  # name, wrapper, kwargs, (B, C, H, W), dtype
        ("cf_flagship", "fused_dense_block_cf", {}, (8, 64, 128, 128),
         "bfloat16"),
        ("cf2_flagship", "fused_dense_block_cf2", {}, (8, 64, 128, 128),
         "bfloat16"),
        ("cf3_flagship", "fused_dense_block_cf3", {}, (8, 64, 128, 128),
         "bfloat16"),
        ("cf3_save_acts", "fused_dense_block_cf3", {"save_acts": True},
         (8, 64, 128, 128), "bfloat16"),
        ("cf6_flagship", "fused_dense_block_cf6", {}, (8, 64, 128, 128),
         "bfloat16"),
        ("cf6_odd_fp32", "fused_dense_block_cf6", {"rows": 8},
         (1, 64, 40, 53), "float32"),
        ("cf_odd_fp32", "fused_dense_block_cf", {"rows": 8},
         (1, 64, 40, 53), "float32"),
    ]
    results = {}
    for name, wrapper, kw, shape, dtype_name in cases:
        fn = getattr(ex, wrapper)
        dtype = getattr(torch, dtype_name)
        x, ws, _, ws_oihw, bs = hwio_block(shape, 32, dtype,
                                           500 + len(results))
        with torch.inference_mode(), no_tf32():
            before = (fn.launches, dense_block.launches)
            out = fn(x, ws, bs, **kw)
            torch.cuda.synchronize()
            per_call = fn.launches - before[0]
            stray = dense_block.launches - before[1]
            plain_kw = dict(kw, rows=kw.get("rows", 16 if "cf3" not in
                                            wrapper else 32))
            ref = ex.dense_block_plain(
                x, *ex._packed(x, ws, bs), res_scale=0.2, slope=0.2,
                save_acts=kw.get("save_acts", False))
            ys = [out[0], *out[1]] if kw.get("save_acts") else [out]
            refs = [ref[0], *ref[1]] if kw.get("save_acts") else [ref]
            atol, rtol = TOL[dtype_name]
            max_err, ok = 0.0, True
            for y, r in zip(ys, refs):
                diff = (y.float() - r.float()).abs()
                max_err = max(max_err, diff.max().item())
                ok = ok and y.shape == r.shape and bool(
                    torch.isfinite(y.float()).all()) and \
                    (diff - rtol * r.float().abs()).max().item() <= atol
            ms = turns({"plain": lambda: ex.dense_block_plain(
                            x, *ex._packed(x, ws, bs), res_scale=0.2,
                            slope=0.2),
                        "kernel": lambda: fn(x, ws, bs, **kw),
                        "library": lambda: cudnn_block(x, ws_oihw, bs)},
                       20)
        bound_ms, bound_by, flops, nbytes = block_bound(shape, 32,
                                                        dtype_name)
        results[name] = dict(
            wrapper=wrapper, rows=plain_kw["rows"], shape=list(shape),
            dtype=dtype_name, launches_per_call=per_call,
            max_abs_err=max_err, atol=atol, rtol=rtol, ok=ok,
            kernel_ms=ms["kernel"], plain_ms=ms["plain"],
            library_ms=ms["library"], bound_ms=bound_ms, bound_by=bound_by,
            roofline_share=bound_ms / ms["kernel"])
        print("[kernel-experiments] " + json.dumps({name: results[name]}),
              flush=True)
        if per_call != LAUNCHES_PER_BLOCK or stray:
            fail(f"{name}: one call made {per_call} launches on "
                 f"{wrapper}.launches and {stray} on dense_block.launches")
        if not ok:
            fail(f"{name}: {wrapper} disagrees with the plain block (max "
                 f"|err| {max_err})")
    return results


# (n_convs, channels, growth): tests/test_pallas.py's general geometries,
# widths that are not multiples of 8, widths above 64
CONTRACT_GEOMETRIES = ((4, 8, 4), (5, 16, 4), (3, 8, 8), (5, 12, 6),
                       (5, 96, 72))


def contract_phase():
    """The dense block's full calling contract on the card: at every
    geometry of CONTRACT_GEOMETRIES, bf16 and fp32, the forward (NCHW and
    NHWC), the backward (two runs bit for bit), v3–v6 and v8 against their
    plain versions at the tolerances above, and launches by their
    formulas; then the RRDBNet forward with 4 convs per block and growth
    4 under auto and pallas_fused against the same forward through the
    plain kernels."""
    import importlib

    import torch

    import super_resolution_tpu_torch.models.rrdb as rrdb
    from super_resolution_tpu_torch.config import GeneratorConfig
    from super_resolution_tpu_torch.device import no_tf32

    db = importlib.import_module(
        "super_resolution_tpu_torch.ops.dense_block")
    ex = importlib.import_module(
        "super_resolution_tpu_torch.ops.experiments_dense_block")

    class Uncounted:        # checks are not the main path
        launches = 0

    def close(got, want, tol):
        atol, rtol = tol
        d = (got.float() - want.float()).abs()
        return (got.shape == want.shape
                and bool(torch.isfinite(got.float()).all())
                and (d - rtol * want.float().abs()).max().item() <= atol,
                d.max().item())

    def rel(got, want):
        want = want.float()
        return ((got.float() - want).abs().max()
                / want.abs().max().clamp_min(1e-30)).item()

    results, bad = {}, []
    kw = dict(res_scale=0.2, slope=0.2)
    for n, c, growth in CONTRACT_GEOMETRIES:
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            name = f"n{n}_c{c}_g{growth}_{dtype_name}"
            shape = (2, c, 40, 53)              # rows 8 divide H
            gen = torch.Generator().manual_seed(700 + len(results))
            x = torch.randn(shape, generator=gen).to("cuda", dtype)
            g = torch.randn(shape, generator=gen).to("cuda", dtype)
            hwio, bs = [], []
            for cin_k, cout in block_convs(c, growth, n):
                hwio.append((torch.randn(3, 3, cin_k, cout, generator=gen)
                             * math.sqrt(2.0 / (9 * cin_k))).to("cuda",
                                                                dtype))
                bs.append((torch.randn(cout, generator=gen) * 0.1).cuda())
            ws = [db.pack_weight(w.permute(3, 2, 0, 1)) for w in hwio]
            res = {}
            with torch.no_grad(), no_tf32():
                f0 = db.dense_block.launches
                y, feats = db.dense_block(x, ws, bs, save_acts=True, **kw)
                y_nhwc = db.fused_dense_block(
                    x.permute(0, 2, 3, 1).contiguous(), ws, bs, **kw)
                b0 = db.dense_block_bwd.launches
                dx, dws, dbs = db.dense_block_bwd(feats, ws, g, **kw)
                dx2, dws2, dbs2 = db.dense_block_bwd(feats, ws, g, **kw)
                torch.cuda.synchronize()
                launches = (db.dense_block.launches - f0,
                            (db.dense_block_bwd.launches - b0) // 2)
                ref = db.dense_block_plain(x, ws, bs, **kw)
                res["fwd"] = close(y, ref, TOL[dtype_name])
                res["fwd_nhwc"] = close(y_nhwc.permute(0, 3, 1, 2), ref,
                                        TOL[dtype_name])
                rx, rws, rbs = db.plain_backward(feats, ws, g, **kw)
                tol = BWD_TOL[dtype_name]
                err = dict(dx=rel(dx, rx),
                           dw=max(rel(a, b_) for a, b_ in zip(dws, rws)),
                           db=max(rel(a, b_) for a, b_ in zip(dbs, rbs)))
                repeats = torch.equal(dx, dx2) and all(
                    torch.equal(a, b_)
                    for a, b_ in zip(dws + dbs, dws2 + dbs2))
                res["bwd"] = (all(err[k] <= tol[k] for k in err) and repeats,
                              err["dx"])
                for v in ("cf", "cf2", "cf3", "cf6"):
                    fn = getattr(ex, f"fused_dense_block_{v}")
                    res[v] = close(fn(x, hwio, bs, rows=8), ref,
                                   TOL[dtype_name])
                y8 = ex.fused_dense_block_cf8(x, hwio, bs, rows=8)
                r8 = ex.fused_dense_block_cf8_plain(x, hwio, bs, rows=8)
                ulp = 2.0 ** -7 if dtype_name == "bfloat16" else 2.0 ** -23
                d8 = (y8.float() - r8.float()).abs()
                res["cf8"] = (bool(torch.isfinite(y8.float()).all()) and bool(
                    (d8 <= ulp * r8.float().abs()).all()), d8.max().item())
            want = (db.fwd_launches(n), db.bwd_launches(n, dtype))
            ok = all(v[0] for v in res.values()) and launches == want
            results[name] = dict(
                shape=list(shape), n_convs=n, growth=growth, ok=ok,
                launches=list(launches), want_launches=list(want),
                bwd_rel_err=err, bwd_repeats_bit_for_bit=repeats,
                max_abs_err={k: v[1] for k, v in res.items()},
                failed=[k for k, v in res.items() if not v[0]])
            print("[contract] " + json.dumps({name: results[name]}),
                  flush=True)
            if not ok:
                bad.append(name)

    # the model with 4 convs per dense block and growth 4
    for impl in ("auto", "pallas_fused"):
        gcfg = GeneratorConfig(n_blocks=2, filters=8, growth=4,
                               n_dense_convs=4, init=SEED_INIT,
                               conv_impl=impl)
        model = rrdb.RRDBNet(gcfg, torch.Generator().manual_seed(3)).cuda()
        x = torch.randn(2, 40, 52, 3, generator=torch.Generator()
                        .manual_seed(4)).cuda()
        out = {}
        for dtype_name in ("bfloat16", "float32"):
            model.prepare(getattr(torch, dtype_name))
            with torch.inference_mode():
                counter = db.dense_block if impl == "auto" \
                    else db.fused_dense_block
                before = counter.launches
                got = model(x)
                torch.cuda.synchronize()
                launches = counter.launches - before
                with PlainKernels():
                    ref = model(x)
            rng_ = (ref.max() - ref.min()).item()
            mse = ((got - ref) ** 2).mean().item()
            psnr = 10 * math.log10(rng_ ** 2 / mse) if mse > 0 \
                else float("inf")
            atol, rtol = FP32_MODEL_TOL
            worst = ((got - ref).abs() - rtol * ref.abs()).max().item()
            ok = (tuple(got.shape) == (2, 160, 208, 3)
                  and bool(torch.isfinite(got).all())
                  and launches == 2 * gcfg.n_dense * 4
                  and (psnr >= BF16_MODEL_PSNR_FLOOR_DB
                       if dtype_name == "bfloat16" else worst <= atol))
            out[dtype_name] = dict(ok=ok, psnr_db=psnr, launches=launches,
                                   max_abs_err=(got - ref).abs().max()
                                   .item())
        name = f"rrdbnet_n4_g4_{impl}"
        results[name] = out
        print("[contract] " + json.dumps({name: out}), flush=True)
        if not all(v["ok"] for v in out.values()):
            bad.append(name)
    if bad:
        fail(f"the dense block's contract failed on the card: {bad}")
    return results


def int8_bound(shape, growth, rows, dtype_name, n=5):
    """(bound_ms, bound_by, ops, bytes) of the n-conv int8 block: every
    band's convs over its own window rows (the halo recompute counted) at
    the int8 peak, against each input (x, weights, biases) read once and
    y written once."""
    b, c, h, w = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    convs = block_convs(c, growth, n)
    macs = sum((rows + 2 * (n - k - 1)) * 9 * cin * cout
               for k, (cin, cout) in enumerate(convs))
    ops = 2 * macs * w * b * (h // rows)
    nbytes = 2 * b * c * h * w * elt + sum(9 * cin * cout * elt + 4 * cout
                                           for cin, cout in convs)
    t_ops, t_bytes = ops / PEAK_FLOPS["int8"], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def int8_sass_line(build):
    """From ``cuobjdump -sass`` of the int8 library: the int8 GMMA
    (wgmma) instructions of each conv instantiation, and the library's
    mma.sync (IMMA / HMMA) instructions, which must be none."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "[build] cuobjdump -sass, dense_block_int8: not measured " \
            "(no cuobjdump)", True
    out = subprocess.run([tool, "-sass", build.library_path(
        "dense_block_int8")], capture_output=True, text=True, timeout=300,
        check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"IGMMA": 0, "HGMMA": 0, "mma.sync": 0}
        elif name is not None:
            op = re.search(r"\b(IGMMA|HGMMA|IMMA|HMMA)\.", line)
            if op:
                key = op.group(1) if "GMMA" in op.group(1) else "mma.sync"
                counts[name][key] += 1
    pat = re.compile(r"conv_int8_wgmmaILi(\d+)E(13__nv_bfloat16|f)")
    convs = {}
    for fn, cnt in counts.items():
        m = pat.search(fn)
        if m:
            convs[f"<{m.group(1)},{'bf16' if m.group(2) != 'f' else 'f32'}>"
                  ] = cnt["IGMMA"]
    mma_sync = sum(c["mma.sync"] for c in counts.values())
    ok = bool(convs) and all(convs.values()) and mma_sync == 0
    return ("[build] cuobjdump -sass, dense_block_int8: IGMMA (s8 wgmma) "
            f"instructions per conv_int8_wgmma instantiation {convs}; "
            f"mma.sync (IMMA/HMMA) in the library: {mma_sync} "
            f"({len(counts)} kernels)"), ok


def int8_build_lines(build):
    """ptxas's report of the int8 library's kernels, and the conv's plan
    at the flagship block's shapes in both dtypes."""
    import re

    import torch

    from super_resolution_tpu_torch.ops import experiments_dense_block as ex

    parts = []
    for k in build.ptxas_report("dense_block_int8"):
        m = re.search(r"conv_int8_wgmmaILi(\d+)E(13__nv_bfloat16|f)",
                      k["kernel"])
        name = (f"conv_int8_wgmma<{m.group(1)},"
                f"{'bf16' if m.group(2) != 'f' else 'f32'}>" if m else
                next((n for n in ("int8_prep_weights", "int8_band")
                      if n in k["kernel"]), k["kernel"][:40]))
        parts.append(f"{name} {k['registers']} regs, spills "
                     f"{k['spill_stores']}/{k['spill_loads']} B"
                     + (f", {len(k['notes'])} wgmma notes: {k['notes']}"
                        if k["notes"] else ""))
    plans = {f"{dt}:{cin}->{cout}": ex.int8_plan(cout, cin,
                                                  getattr(torch, dt))
             for dt in ("bfloat16", "float32")
             for cin, cout in block_convs(64, 32) + [(384, 96)]}
    return ["[build] ptxas -v, dense_block_int8: " + "; ".join(parts),
            "[build] int8 plans " + json.dumps(plans)]


def parent_int8(cases):
    """v8 of the checkout named by CHIP_SMOKE_PARENT (an earlier commit)
    on the same inputs, in a subprocess with its own build: name -> y on
    the card, or None where no parent is named."""
    import torch

    parent = os.environ.get("CHIP_SMOKE_PARENT")
    if not parent:
        return None
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({k: [v[0].cpu(), [w.cpu() for w in v[1]],
                        [b.cpu() for b in v[2]], v[3]]
                    for k, v in cases.items()}, os.path.join(tmp, "in.pt"))
        code = (
            "import sys, torch\n"
            f"sys.path.insert(0, {os.path.abspath(parent)!r})\n"
            "from super_resolution_tpu_torch.ops import "
            "experiments_dense_block as ex\n"
            f"d = torch.load({os.path.join(tmp, 'in.pt')!r})\n"
            "out = {}\n"
            "with torch.inference_mode():\n"
            "    for k, (x, ws, bs, rows) in d.items():\n"
            "        out[k] = ex.fused_dense_block_cf8(x.cuda(), "
            "[w.cuda() for w in ws], [b.cuda() for b in bs], "
            "rows=rows).cpu()\n"
            f"torch.save(out, {os.path.join(tmp, 'out.pt')!r})\n")
        proc = subprocess.run([sys.executable, "-c", code],
                              cwd=os.path.abspath(parent),
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"the parent's v8 failed: {proc.stderr[-2000:]}")
        return torch.load(os.path.join(tmp, "out.pt"))


def int8_phase():
    """v8: the int8 kernels against their plain version, against the
    bf16 dense-block kernel and, where named, against an earlier
    commit's v8."""
    import torch

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops import experiments_dense_block as ex
    from super_resolution_tpu_torch.ops.dense_block import dense_block

    fn = ex.fused_dense_block_cf8
    cases = [("flagship_rows16", (8, 64, 128, 128), 32, "bfloat16", 16),
             ("flagship_rows32", (8, 64, 128, 128), 32, "bfloat16", 32),
             ("fp32_growth8", (2, 16, 48, 40), 8, "float32", 8)]
    results, outs, inputs = {}, {}, {}
    for name, shape, growth, dtype_name, rows in cases:
        dtype = getattr(torch, dtype_name)
        x, ws, wp, ws_oihw, bs = hwio_block(shape, growth, dtype, 600)
        inputs[name] = (x, ws, bs, rows)
        with torch.inference_mode(), no_tf32():
            before = fn.launches
            y = fn(x, ws, bs, rows=rows)
            torch.cuda.synchronize()
            per_call = fn.launches - before
            ref = ex.fused_dense_block_cf8_plain(x, ws, bs, rows=rows)
            diff = (y.float() - ref.float()).abs()
            ulp = 2.0 ** -7 if dtype_name == "bfloat16" else 2.0 ** -23
            within_ulp = bool((diff <= ulp * ref.float().abs()).all())
            finite = bool(torch.isfinite(y.float()).all())
            block = dense_block(x, wp, bs, res_scale=0.2, slope=0.2).float()
            class_rel = ((y.float() - block).abs().max()
                         / block.abs().max()).item()
            ms = turns({"plain": lambda: ex.fused_dense_block_cf8_plain(
                            x, ws, bs, rows=rows),
                        "kernel": lambda: fn(x, ws, bs, rows=rows),
                        "library": lambda: cudnn_block(x, ws_oihw, bs)},
                       10)
            # the kernels alone, by name, and the bf16 dense block's
            # kernel on the same block in the same call, as the yardstick
            calls = 5
            _, by_name = device_times(
                lambda: [fn(x, ws, bs, rows=rows) for _ in range(calls)])
            by_kernel = {k: sum(t for n_, t in by_name.items() if k in n_)
                         / calls for k in INT8_KERNELS}
            dev_ms = sum(by_kernel.values()) if by_name else None
            block_dev_ms = own_device_ms(
                lambda: dense_block(x, wp, bs, res_scale=0.2, slope=0.2))
        outs[name] = y
        bound_ms, bound_by, ops, nbytes = int8_bound(shape, growth, rows,
                                                     dtype_name)
        results[name] = dict(
            shape=list(shape), growth=growth, rows=rows, dtype=dtype_name,
            launches_per_call=per_call, max_abs_err=diff.max().item(),
            share_differing=(diff > 0).float().mean().item(),
            within_one_ulp=within_ulp, rel_to_bf16_block=class_rel,
            kernel_ms=ms["kernel"], kernels_device_ms=dev_ms,
            kernels_device_ms_by_name=by_kernel if by_name else None,
            bf16_block_device_ms=block_dev_ms,
            plain_ms=ms["plain"], library_ms=None,
            cudnn_block_ms=ms["library"],
            bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=nbytes,
            roofline_share=bound_ms / ms["kernel"],
            device_roofline_share=(bound_ms / dev_ms if dev_ms else None),
            tops=ops / (ms["kernel"] * 1e-3) / 1e12)
        print("[kernel-int8] " + json.dumps({name: results[name]}),
              flush=True)
        if per_call != ex.int8_launches(len(ws)):
            fail(f"int8 {name}: one call made {per_call} launches, want "
                 f"{ex.int8_launches(len(ws))}")
        if not (finite and within_ulp and y.shape == ref.shape):
            fail(f"int8 {name}: kernel differs from its plain version by "
                 f"more than one ULP of {dtype_name} (max |err| "
                 f"{diff.max().item()})")
        if not class_rel < INT8_CLASS_REL:
            fail(f"int8 {name}: {class_rel} of the largest |y| from the "
                 f"bf16 dense-block kernel (class {INT8_CLASS_REL})")
    differ = (outs["flagship_rows16"] != outs["flagship_rows32"]).float() \
        .mean().item()
    print(f"[kernel-int8] rows 16 against rows 32 at (8, 64, 128, 128): "
          f"{differ:.4f} of the values differ (band-local scales)",
          flush=True)
    if not differ > 0:
        fail("the int8 block gave the same values at rows 16 and 32: its "
             "scales are not band-local")
    results["rows16_vs_rows32_share_differing"] = differ
    parent = parent_int8(inputs)
    if parent is None:
        print("[kernel-int8] parent kernel: not compared (CHIP_SMOKE_PARENT "
              "names no checkout)", flush=True)
    else:
        same = {k: dict(equal=bool(torch.equal(outs[k].cpu(), v)),
                        share_differing=(outs[k].cpu() != v).float().mean()
                        .item(),
                        max_abs_diff=(outs[k].cpu().float() - v.float())
                        .abs().max().item())
                for k, v in parent.items()}
        print("[kernel-int8] parent kernel "
              f"({os.environ['CHIP_SMOKE_PARENT']}), value for value: "
              + json.dumps(same), flush=True)
        results["parent_equal"] = same
    return results


def run_tool(name, argv, timeout):
    """``python -m super_resolution_tpu_torch.tools.<name> argv`` on the
    card, from the repository root; its standard output."""
    proc = subprocess.run(
        [sys.executable, "-m", f"super_resolution_tpu_torch.tools.{name}",
         *argv], cwd=HERE, capture_output=True, text=True, timeout=timeout)
    for line in proc.stdout.splitlines():
        print(f"[tools] {name}: {line}", flush=True)
    if proc.returncode != 0:
        fail(f"tools.{name} exited {proc.returncode}: {proc.stderr[-2000:]}")
    if "FAILED" in proc.stdout:
        fail(f"tools.{name} printed FAILED")
    return proc.stdout


MODEL_VARIANTS = ["lax", "prod"] + [f"{b}+{t}" for b in ("v4", "v5", "v6",
                                                         "v9")
                                    for t in ("laxtail", "ktail")]
BLOCK_COUNTER = {"v4": "fused_dense_block_cf3", "v5": "dense_block",
                 "v6": "fused_dense_block_cf6", "v9": "dense_block"}


def tools_phase():
    """The three tools' main path: kernel_bench over every block variant
    and model_bench over every model variant, as subprocesses."""
    import re

    from super_resolution_tpu_torch.ops.dense_block import LAUNCHES_PER_BLOCK
    from super_resolution_tpu_torch.config import GeneratorConfig

    gcfg = GeneratorConfig()
    per_forward = gcfg.n_blocks * gcfg.n_dense * LAUNCHES_PER_BLOCK
    tail = 2 + gcfg.n_upsample
    out = run_tool("kernel_bench",
                   ["--variants", "lax,v3,v3b,v4,v5,v6,v8,v9"], 600)
    kb_launches = json.loads(out.rstrip().splitlines()[-1]
                             .split("launches: ", 1)[1])
    times = {}
    for v in ("v3", "v3b", "v4", "v5", "v6", "v8", "v9"):
        for rows in (16, 32):
            m = re.search(rf"^{v} rows={rows:2d}:\s+([\d.]+) ms", out, re.M)
            if not m:
                fail(f"kernel_bench printed no time for {v} rows={rows}")
            times[f"{v}_rows{rows}"] = float(m.group(1))
    m = re.search(r"^lax\s+:\s+([\d.]+) ms", out, re.M)
    if not m:
        fail("kernel_bench printed no time for lax")
    times["lax"] = float(m.group(1))
    idle = [n for n in ("fused_dense_block_cf", "fused_dense_block_cf2",
                        "fused_dense_block_cf3", "fused_dense_block_cf6",
                        "fused_dense_block_cf8", "dense_block")
            if not kb_launches.get(n)]
    if idle:
        fail(f"kernel_bench launched no kernel through {idle}")
    # v8's launches by its formula: two variants (rows 16 and 32), each
    # a warm-up and timed calls, n + 2 launches a call
    from super_resolution_tpu_torch.ops.experiments_dense_block import (
        INT8_LAUNCHES_PER_CALL)
    v8_launches = kb_launches["fused_dense_block_cf8"]
    if v8_launches % INT8_LAUNCHES_PER_CALL:
        fail(f"kernel_bench's v8 launched {v8_launches}, not a multiple of "
             f"{INT8_LAUNCHES_PER_CALL} (n + 2 a call)")

    out = run_tool("model_bench", ["--variants", ",".join(MODEL_VARIANTS),
                                   "--iters", "3"], 900)
    mb_launches = json.loads(out.rstrip().splitlines()[-1]
                             .split("launches: ", 1)[1])
    model = {}
    for v in MODEL_VARIANTS:
        m = re.search(rf"^{re.escape(v)}\s*:\s+([\d.]+) ms/batch\s+"
                      rf"([\d.]+) MP/s.*launches (\{{.*\}})$", out, re.M)
        if not m:
            fail(f"model_bench printed no time for {v}")
        launches = json.loads(m.group(3))
        model[v] = dict(ms=float(m.group(1)), mp_per_s=float(m.group(2)),
                        launches=launches)
        if v == "lax":
            want = {}
        elif v == "prod":
            want = {"dense_block": per_forward}
        else:
            block, t = v.split("+")
            want = {BLOCK_COUNTER[block]: per_forward}
            if t == "ktail":
                want["conv3x3"] = tail
        if launches != want:
            fail(f"model_bench {v}: one forward launched {launches}, want "
                 f"{want}")
    res = dict(kernel_bench_ms=times, kernel_bench_launches=kb_launches,
               model_bench=model, model_bench_launches=mb_launches)
    print("[tools] " + json.dumps(res), flush=True)
    return res


def lax_train_phase():
    """``cli train --preset train_gan_dfm --conv_impl pallas``, full
    width, one warmup and one GAN step: it trains on ``lax`` (no
    backward of its own, as in the JAX package), says so, launches no
    kernel of the port and gives finite metrics."""
    import contextlib
    import io

    with tempfile.TemporaryDirectory() as tmp:
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc, records, totals = cli_train_recorded(
                ["train", "--preset", "train_gan_dfm", "--conv_impl",
                 "pallas", "--dataset_dir", os.path.join(tmp, "no_dataset"),
                 "--steps", "2", "--warmup_batches", "1",
                 "--checkpoint_dir", os.path.join(tmp, "ck")])
    print(said.getvalue(), end="", flush=True)
    for i, r in enumerate(records):
        print(f"[train-lax] step {i + 1} " + json.dumps(r), flush=True)
    line = "training on 'lax'" in said.getvalue()
    print(f"[train-lax] cli train --conv_impl pallas: rc {rc}, printed the "
          f"lax line: {line}, launches over the run {totals}", flush=True)
    if rc != 0 or [r["kind"] for r in records] != ["warmup", "gan"] \
            or not line:
        fail(f"cli train --conv_impl pallas: rc {rc}, steps "
             f"{[r['kind'] for r in records]}, lax line {line}")
    if any(totals.values()):
        fail(f"cli train on lax launched kernels of the port: {totals}")
    for i, r in enumerate(records):
        bad = [k for k, v in r["metrics"].items() if not math.isfinite(v)]
        if bad:
            fail(f"lax step {i + 1}: metrics {bad} not finite")
    return dict(warmup_step_ms=records[0]["ms"], gan_step_ms=records[1]["ms"],
                totals=totals)


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
    build.build_all()            # one nvcc per source, started together
    for name in build.SOURCES:
        build.load(name)
    print(f"[build] {len(build.SOURCES)} kernel source(s) built with nvcc "
          f"for sm_90a in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(os.path.relpath(build.library_path(n), HERE)
                      for n in build.SOURCES), flush=True)
    for line in ptxas_lines(build):
        print(line, flush=True)
    print(plan_line(), flush=True)
    for line in int8_build_lines(build):
        print(line, flush=True)
    line, sass_ok = int8_sass_line(build)
    print(line, flush=True)
    if not sass_ok:
        fail("the int8 conv is not on s8 wgmma (no IGMMA in an "
             "instantiation) or the int8 library has mma.sync")
    tile_checks_phase()

    kern = kernel_phase()
    kern_bwd = bwd_kernel_phase()
    model_phase()
    serve, frame = serve_phase()
    train = train_phase()
    conv = conv3x3_phase()
    fused = fused_phase()
    impls = impls_phase(frame)
    tail_train = tail_train_phase()
    lax_train = lax_train_phase()
    experiments = experiments_phase()
    int8 = int8_phase()
    contract_phase()
    tools = tools_phase()
    print("[impls] lax: " + json.dumps({
        "forward": impls["lax"], "cli": impls["cli_lax"],
        "train_pallas_on_lax": lax_train}), flush=True)

    flag, bwd = kern["flagship"], kern_bwd["train"]
    serve_launches = serve["upscale_launches"] + serve["serve_launches"]
    print(json.dumps({"kernels": [{
        "name": "dense_block",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/dense_block.cu",
        "replaces": REPLACES,
        # the user's entry points, each counted from 0: cli upscale and
        # cli serve --once, then cli train
        "launches": serve_launches + train["fwd_launches"],
        "launches_serve_path": serve_launches,
        "launches_train_path": train["fwd_launches"],
        "max_abs_err": flag["max_abs_err"],
        "ms": flag["kernel_ms"],
        "plain_ms": flag["plain_ms"],
        "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"],
        "library_ms": flag["library_ms"],
        "train_shape_ms": kern["train"]["kernel_ms"],
    }, {
        "name": "dense_block_bwd",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/dense_block_bwd.cu",
        "replaces": REPLACES_BWD,
        "launches": train["bwd_launches"],        # cli train
        "launches_per_block": bwd["launches"],
        "max_abs_err": bwd["max_abs_err"],
        "ms": bwd["kernel_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
        "kernels_device_ms": bwd["kernels_device_ms"],
    }, {
        "name": "conv3x3",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/conv3x3.cu",
        "replaces": REPLACES_CONV,
        # cli upscale --conv_impl pallas_cf_tail and pallas, then cli
        # train --conv_impl pallas_cf_tail, each counted from 0
        "launches": (impls["cli_pallas_cf_tail"]["launches"]["conv3x3"]
                     + impls["cli_pallas"]["launches"]["conv3x3"]
                     + tail_train["totals"]["conv3x3"]),
        "launches_upscale_pallas_cf_tail":
            impls["cli_pallas_cf_tail"]["launches"]["conv3x3"],
        "launches_upscale_pallas": impls["cli_pallas"]["launches"]["conv3x3"],
        "launches_train_pallas_cf_tail": tail_train["totals"]["conv3x3"],
        # the flagship tail's 512 x 512 plane (hr_conv, upconv2)
        "max_abs_err": conv["hr_conv_512"]["max_abs_err"],
        "ms": conv["hr_conv_512"]["kernel_ms"],
        "plain_ms": conv["hr_conv_512"]["plain_ms"],
        "bound_ms": conv["hr_conv_512"]["bound_ms"],
        "bound_by": conv["hr_conv_512"]["bound_by"],
        "library_ms": conv["hr_conv_512"]["library_ms"],
        "ms_by_shape": {k: v["kernel_ms"] for k, v in conv.items()},
    }, {
        "name": "dense_block_nhwc",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/dense_block.cu",
        "replaces": REPLACES_NHWC,
        # cli upscale --conv_impl pallas_fused, counted from 0
        "launches": impls["cli_pallas_fused"]["launches"][
            "dense_block_nhwc"],
        "max_abs_err": fused["flagship"]["max_abs_err"],
        "ms": fused["flagship"]["kernel_ms"],
        "plain_ms": fused["flagship"]["plain_ms"],
        "bound_ms": fused["flagship"]["bound_ms"],
        "bound_by": fused["flagship"]["bound_by"],
        "library_ms": fused["flagship"]["library_ms"],
    }, {
        "name": "dense_block_experiments",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/dense_block.cu",
        "replaces": REPLACES_EXPERIMENTS,
        # tools.kernel_bench and tools.model_bench, each counted from 0,
        # on the wrappers of v3, v3b, v4 and v6
        "launches": sum(tools[k].get(n, 0)
                        for k in ("kernel_bench_launches",
                                  "model_bench_launches")
                        for n in ("fused_dense_block_cf",
                                  "fused_dense_block_cf2",
                                  "fused_dense_block_cf3",
                                  "fused_dense_block_cf6")),
        "launches_by_wrapper": {
            n: tools["kernel_bench_launches"].get(n, 0)
            + tools["model_bench_launches"].get(n, 0)
            for n in ("fused_dense_block_cf", "fused_dense_block_cf2",
                      "fused_dense_block_cf3", "fused_dense_block_cf6")},
        "max_abs_err": max(v["max_abs_err"] for v in experiments.values()),
        "ms": experiments["cf3_flagship"]["kernel_ms"],
        "plain_ms": experiments["cf3_flagship"]["plain_ms"],
        "bound_ms": experiments["cf3_flagship"]["bound_ms"],
        "bound_by": experiments["cf3_flagship"]["bound_by"],
        "library_ms": experiments["cf3_flagship"]["library_ms"],
        "ms_by_case": {k: v["kernel_ms"] for k, v in experiments.items()},
    }, {
        "name": "dense_block_int8",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/dense_block_int8.cu",
        "replaces": REPLACES_INT8,
        # tools.kernel_bench v8, counted from 0
        "launches": tools["kernel_bench_launches"]["fused_dense_block_cf8"],
        "max_abs_err": int8["flagship_rows16"]["max_abs_err"],
        "ms": int8["flagship_rows16"]["kernel_ms"],
        "plain_ms": int8["flagship_rows16"]["plain_ms"],
        "bound_ms": int8["flagship_rows16"]["bound_ms"],
        "bound_by": int8["flagship_rows16"]["bound_by"],
        # no PyTorch call computes this function; cuDNN's bf16 block for
        # scale
        "library_ms": None,
        "cudnn_bf16_block_ms": int8["flagship_rows16"]["cudnn_block_ms"],
        # row 11's kernels: n + 2 launches a call
        "kernels": list(INT8_KERNELS),
        "launches_per_call": int8["flagship_rows16"]["launches_per_call"],
        "kernels_device_ms": int8["flagship_rows16"]["kernels_device_ms"],
        "kernels_device_ms_by_name":
            int8["flagship_rows16"]["kernels_device_ms_by_name"],
        "bf16_block_device_ms":
            int8["flagship_rows16"]["bf16_block_device_ms"],
        "ms_rows32": int8["flagship_rows32"]["kernel_ms"],
        "kernels_device_ms_rows32":
            int8["flagship_rows32"]["kernels_device_ms"],
    }]}))
    print(smi)                       # card name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
