#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``super_resolution_tpu_torch``) on
one NVIDIA GPU: the whole on-card verdict in one command, and the
kernels' times.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Every check of a kernel or a model against its plain version, a bound or
a launch formula is a ``cuda``-marked test in ``tests/test_torch_cuda.py``
(bounds in ``tests/torch_checks.py``); this script runs them once, and
otherwise measures, and drives what needs the CLI, the tools or several
processes.  Phases, in order; a failed one raises, so the script exits
nonzero and prints no result line:

1. build: the card (name and power limit from nvidia-smi), torch and
   CUDA; every kernel of the port built from ``csrc/`` with nvcc
   (timed); what ``ptxas -v`` reports for each kernel of the Hopper tile
   (``csrc/conv3x3_wgmma.cuh``), of the bf16 backward and of the int8
   block (registers, shared memory, spills), the tile's plan (N, K
   chunk, stages, weights resident, dynamic shared memory) at the main
   path's shapes and the int8 conv's, and, from ``cuobjdump -sass``, the
   int8 conv's s8 GMMA instructions (and that the library has no
   ``mma.sync``).
2. card-tests: ``python -m pytest --noconftest -p no:cacheprovider -m
   cuda tests/test_torch_cuda.py`` as a subprocess; it must exit 0.  The
   tests that drive a path of the port (``cli upscale`` under
   pallas_cf_tail, pallas and pallas_fused, ``cli train`` under
   pallas_cf_tail, the bench's workload, ``eval_batch``, the polyphase
   forwards) log the launches they counted to a file that
   ``$CARD_LAUNCH_LOG`` names, and the smoke reads them back.
3. the kernels' times, in turns (plain, kernel, library, library,
   kernel, plain) with CUDA events, against their bounds
   (``benchmark/lib/flops.py``) and roofline shares, at the shapes of
   ``PERF.md`` section 6: ``[kernel]`` the dense-block forward at the
   flagship block (8, 64, 128, 128) and the training shape (16, 64, 48,
   48), bf16; ``[kernel-bwd]`` its backward at the training shape (the
   library: autograd through five cuDNN convs), with the kernels' own
   device time; ``[kernel-conv3x3]`` the single conv at the flagship
   tail's shapes (8 x 64 x 128², 256², 512² -> 64), conv_first, conv_last
   and the pixel-shuffle upconv; ``[kernel-fused]`` the NHWC dense-block
   entry at the flagship block; ``[kernel-experiments]`` v3, v3b, v4
   (with and without ``save_acts``) and v6 there; ``[kernel-int8]`` v8
   at rows 16 and 32 there and in fp32 at growth 8, its kernels' device
   time by name beside the bf16 block's, and with ``CHIP_SMOKE_PARENT``
   naming a checkout of an earlier commit, that commit's v8 on the same
   inputs, value for value; ``[swinir]`` the window attention at (1,
   1024², 720) bf16, shift 0 and 4 (the library: roll, partition, one
   ``scaled_dot_product_attention`` with the bias and mask as its mask),
   and SwinIR-L's forward at 512² and 1024² with its launches;
   ``[add-layernorm]`` the add-and-LayerNorm kernel at (1, 1024², 240)
   with a branch and without (the library: ``x + b``, then
   ``F.layer_norm``).
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
6. eval (right after train): ``cli eval --json`` of the full-width
   generator (the serve phase's seeded weights, bf16, ``auto``) over
   three synthetic HR frames (512 x 512, 480 x 640, 404 x 724: LR sides
   101 and 181 not multiples of 8) at tile 96: the four keys, one
   dense-block launch per conv of every dense block of every tile batch,
   the same eval through the plain dense block within 0.05 dB and 1e-3
   SSIM, ``ssim`` / ``psnr01`` on CUDA tensors against CPU tensors
   within 1e-5 with cuDNN's TF32 default on, ``--self_ensemble`` and a
   paired ``--lr_dir`` once each; seconds per image and output MP/s.
7. export: ``cli export`` of the train phase's checkpoint directory with
   the default halo sweep (frame 192, tile_w 64, halos 2,4,6,8; fp32
   lax, TF32 off, on the card) and ``--val_dir`` the eval frames: the
   step-6 EMA gated out, the sidecar's sweep rows and val contract,
   ``cli upscale --halo auto`` reading the stamp, the release and the
   directory giving the same bytes in ``cli upscale``, ``--ema`` writing
   {params, params_ema}, ``cli interp`` of the release and the serve
   weights at alpha 0, 1 (bit for bit) and 0.5 (1e-6); the sweep's wall
   time.
8. halo-parity (right after export, on its directories):
   ``tools.halo_parity`` of the train phase's step directory
   (``--weights auto``, float32 and bfloat16) and of the serve phase's
   weights as a ``.pth``: a line per halo (2, 4, 6, 8, 12), dense-block
   launches in whole forwards.
9. tools: ``python -m super_resolution_tpu_torch.tools.kernel_bench
   --variants lax,v3,v3b,v4,v5,v6,v8,v9`` and ``tools.model_bench`` over
   every variant (``--iters 3``) as subprocesses on the card: a time for
   every variant, no ``FAILED``, and per model forward 345 dense-block
   launches on each variant's own counter (+4 tail launches under
   ``ktail``), none under ``lax``.
10. train-dp: full-width ``train_gan_dfm`` (23 blocks, global batch 16
   of 192^2 HR, bf16).  (a) ``cli train --data_parallel 1 --multihost
   --num_processes 1 --process_id 0 --coordinator 127.0.0.1:<port>``
   (NCCL, one rank), 2 warmup + 2 GAN steps, equal bit for bit to the
   plain ``cli train`` in every tensor of the checkpoint (parameters,
   D statistics, Adam states, EMA, generators), every step's metrics
   and the logged line (cuDNN deterministic in both); one profiled GAN
   step under that group.  (b) two ranks on the one card over gloo
   (``parallel.dp.launch`` with the device list ``cuda:0, cuda:0``), 8
   rows each, one GAN step of each shape (the reference 4-forward step
   and ``dedup_d_hr``) against one process with the 16 rows: losses
   within 5e-4, G and D parameters and D's running statistics within
   1e-3 (the JAX package's tolerances), the two ranks equal bit for
   bit; ms per step per rank, the all-reduces' share of a profiled step
   and the card's idle share.  (c) the per-rank control (rank 0's rows
   alone, no all-reduce) must miss those tolerances.
11. profile-dir: ``cli train --profile_dir D`` (1 + 1 steps, 2 blocks):
   one trace in D naming the dense-block kernels, forward and backward.
12. build-cache: ``cli upscale --conv_impl pallas --compile_cache_dir
   <fresh>`` (2 blocks) twice, each in its own process with a logging
   ``nvcc`` first on PATH: the first builds conv3x3's library into the
   directory, the second starts no nvcc; both wall times.
Then the last tools, each a subprocess (``run_tool``):
13. grain: ``cli train --loader grain``.  Without the ``grain`` package
   (this machine has none) a nonzero exit naming grain, no step and no
   checkpoint; with it, 2 + 2 steps at 2 blocks, resumed equal to
   straight bit for bit.
14. convert-vgg: ``tools.convert_vgg`` of a seeded VGG-19 state dict
   with torchvision's key names; the port's VGG features from the npz on
   the card (float32, TF32 off) within 1e-4 of the CPU's.
15. grad-bench: ``tools.grad_bench`` at (16, 64, 48²) bf16: lax and
   kernel ms, ``kernel_fold`` not ported, launches by the formulas; on
   its inputs the backward kernels' dx within 2^-6 of the largest |dx|
   of the plain backward's (same buffer and cotangent), and the whole
   forward + backward's dx of kernels, plain block, cuDNN and float32
   against each other, the kernels' and the plain block's distance from
   the float32 dx at most 1.25 times cuDNN's.
16. verify-grads: ``tools.verify_grads_onchip`` at 16 x 192², 23 blocks,
   its own tolerances (losses 1e-4, worst leaf 0.02): exit 0, the loss
   delta and the worst leaf, 345 + 552 launches.
17. train-bench: ``tools.train_bench --step gan`` and ``--step
   pretrain`` under lax, pallas_cf and pallas_cf_tail, ten steps: ms per
   step, it/s, launches of one step by formula (none under lax).
18. profile-gan: ``tools.profile_gan --impl pallas_cf --trace``: the
   component table with each component's device time, the full step,
   the sum; a trace naming ``conv3x3_wgmma``, ``bwd_prep`` and
   ``wgrad_wgmma``; a step's launches by formula.
19. tiled-bench: ``tools.tiled_bench`` on the 2048² LR frame (defaults
   with ``--decompose`` under pallas_cf, then pallas_fused and
   pallas_cf_tail, then 128-wide tiles 128, 256, 384 and 704 high without
   bucketing: the rate against tile height): s/frame, MP/s, the stages,
   345 dense-block launches per tile batch.
20. demo: ``tools.demo_train_eval --steps 200 --gan_steps 50 --blocks 23
   --conv_impl pallas_cf``: completes, every printed number finite, 552
   backward launches per training step; the PSNR model against bicubic
   and the GAN's sharpening recorded, not gated.
21. the ``kernels`` JSON line (each kernel's times from phase 3, its
   launches counted from 0 around the user's entry points of phases
   4-20, in the card tests' runs of phase 2 and, for the window
   attention and the add-and-LayerNorm kernel, SwinIR-L's forwards of
   phase 3; per block or per call, counted around one call of phase 3),
   the card's name and power limit as
   nvidia-smi prints them, then the ``ok`` JSON line last; the total
   wall time on stderr.

It needs a CUDA card and the repository around it; without either it
exits nonzero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]

from benchmark.lib.flops import (  # noqa: E402
    PEAK_BYTES,
    PEAK_FLOPS,
    block_bound,
    block_convs,
    bwd_bound,
    conv_bound,
)
from torch_checks import (  # noqa: E402
    EVAL_PLAIN_PSNR_DB,
    GRAD_BENCH_F32_DELTA,
    LAUNCH_LOG_ENV,
    PlainKernels,
    cli_train_recorded,
    launch_counters,
    read_launch_log,
    rgba_frame,
    seeded_block,
)

# cli upscale in bf16 through the kernel vs through the plain dense
# block, uint8 frames (max and mean |delta| over all values).  bf16
# rounding flips, spread by 69 blocks of order-1 weights, move the
# frames of the serve phase by at most 4 LSB and 0.18 LSB on average on
# an H100 (NVIDIA H100 80GB HBM3, 700 W); a fault at a tile shape (a
# wrong row or column of outputs) moves values by tens of LSB.
CLI_PLAIN_MAX_LSB = 8
CLI_PLAIN_MEAN_LSB = 0.5
REPLACES = ("super_resolution_tpu/ops/pallas/dense_block_cf.py:347 "
            "fused_dense_block_cf5; super_resolution_tpu/ops/pallas/"
            "dense_block_cf_ext.py:309 fused_dense_block_cf9")


REPLACES_BWD = ("super_resolution_tpu/ops/pallas/dense_block_cf_vjp.py:438 "
                "fused_dense_block_cf5_bwd")
TRAIN_SHAPE = (16, 64, 48, 48)     # one dense block's input in training
# A training step through the kernels vs through the plain dense block,
# full width, bf16, from the checkpoint of the train phase.  The two
# forwards differ by bf16 rounding flips, which the losses average over
# all pixels.  In the warmup step the cotangent of SR is
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
REPLACES_EXPERIMENTS = (
    "super_resolution_tpu/ops/pallas/experiments_dense_block.py:122 "
    "fused_dense_block_cf; :262 fused_dense_block_cf2; :379 "
    "fused_dense_block_cf3; :521 fused_dense_block_cf6")
REPLACES_INT8 = ("super_resolution_tpu/ops/pallas/experiments_dense_block.py"
                 ":668 fused_dense_block_cf8")


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


def card_block(shape, growth, dtype, seed):
    """``torch_checks.seeded_block``'s dense block on the card in every
    layout: x, packed, OIHW and HWIO weights, biases."""
    from super_resolution_tpu_torch.ops.dense_block import pack_weight

    x, ws_oihw, bs = seeded_block(shape, growth, dtype, "cuda", seed,
                                  layout="oihw")
    return (x, [pack_weight(w) for w in ws_oihw], ws_oihw,
            [w.permute(2, 3, 1, 0) for w in ws_oihw], bs)


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
    for name in ("dense_block", "dense_block_chain", "conv3x3"):
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


def card_tests():
    """Every check on the card, ``tests/test_torch_cuda.py``'s ``cuda``
    tests, in a subprocess of their own (``--noconftest``:
    ``tests/conftest.py`` imports JAX, which the card's machine lacks).
    Returns the launches that the tests counted on the paths they drive
    (``torch_checks.log_launches``): path -> kernel -> count."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "launches.jsonl")
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-p",
             "no:cacheprovider", "-q", "-rfE", "-m", "cuda",
             "tests/test_torch_cuda.py"], cwd=HERE, capture_output=True,
            text=True, timeout=3000, env=dict(os.environ,
                                              **{LAUNCH_LOG_ENV: log}))
        launches = read_launch_log(log)
    lines = proc.stdout.strip().splitlines()
    print("\n".join(f"[card-tests] {line}" for line in lines[-30:]),
          flush=True)
    print(f"[card-tests] exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode != 0:
        fail(f"the card tests exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    print("[card-tests] launches by path: " + json.dumps(launches),
          flush=True)
    return launches


def timed(fns, iters, bound, **describe):
    """A timing row: ms per call of ``fns``' kernel, plain version and
    library in :func:`turns`, against ``bound`` (bound_ms, bound_by,
    flops, bytes)."""
    ms = turns(fns, iters)
    bound_ms, bound_by, flops, nbytes = bound
    return dict(describe, kernel_ms=ms["kernel"], plain_ms=ms["plain"],
                library_ms=ms["library"], bound_ms=bound_ms,
                bound_by=bound_by, flops=flops, bytes=nbytes,
                roofline_share=bound_ms / ms["kernel"],
                tflops=flops / (ms["kernel"] * 1e-3) / 1e12)


def kernel_times():
    """The dense-block forward kernel at the flagship block and the
    training shape, bf16."""
    import torch

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.dense_block import (
        dense_block,
        dense_block_plain,
    )

    results = {}
    for name, shape, iters in (("flagship", (8, 64, 128, 128), 20),
                               ("train", TRAIN_SHAPE, 50)):
        x, ws, ws_oihw, _, bs = card_block(shape, 32, torch.bfloat16,
                                           len(results))
        kw = dict(res_scale=0.2, slope=0.2)
        with torch.inference_mode(), no_tf32():
            results[name] = timed(
                {"kernel": lambda: dense_block(x, ws, bs, **kw),
                 "plain": lambda: dense_block_plain(x, ws, bs, **kw),
                 "library": lambda: cudnn_block(x, ws_oihw, bs)},
                iters, block_bound(shape, 32, "bfloat16"),
                shape=list(shape), growth=32, dtype="bfloat16", slope=0.2)
        print("[kernel] " + json.dumps({name: results[name]}), flush=True)
    return results


def window_attention_sdpa(qkv, heads, shift, bias_mask):
    """The library's way to one Swin layer's window attention: roll,
    partition, one ``scaled_dot_product_attention`` call with the
    gathered relative bias plus the shift mask as its additive mask
    (``bias_mask``: (B·nW, heads, 64, 64), built once as a model would
    at load time), reverse and roll back; bf16."""
    import torch
    import torch.nn.functional as F

    b, hp, wp, c3 = qkv.shape
    c, w = c3 // 3, 8
    hd, nwy, nwx = c // heads, hp // w, wp // w
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = x.view(b, nwy, w, nwx, w, 3, heads, hd)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nwy * nwx, heads,
                                                  w * w, hd)
    o = F.scaled_dot_product_attention(x[0], x[1], x[2],
                                       attn_mask=bias_mask)
    o = o.view(b, nwy, nwx, heads, w, w, hd)
    o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, hp, wp, c)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def add_layernorm_times():
    """The add-and-LayerNorm kernel (``csrc/add_layernorm.cu``) at (1,
    1024², 240) bf16, with a branch and without: its ms in turns with the
    plain version and the library's (``x + b``, then ``F.layer_norm``:
    the same PyTorch calls as the plain version), against its bound: x
    and the branch read, s and h written (4 passes of 503 MB), or x read
    and h written (2), at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.ops import add_layernorm as aln

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    shape = (1, 1024, 1024, 240)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
         ).to(torch.bfloat16)
    br = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    w = (1 + 0.3 * torch.randn(c, generator=gen, device=dev)
         ).to(torch.bfloat16)
    b = (0.5 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
    ms = {}
    for kind, branch in (("add", br), ("norm", None)):
        ms[kind] = turns({
            "kernel": lambda: aln.add_layernorm(x, branch, w, b, 1e-5),
            "plain": lambda: aln.add_layernorm_plain(x, branch, w, b, 1e-5),
            "library": lambda: F.layer_norm(
                x if branch is None else x + branch, (c,), w, b, 1e-5)},
            20)
    del x, br
    torch.cuda.empty_cache()
    pass_ms = math.prod(shape) * 2 / PEAK_BYTES * 1e3
    bound = {"add": 4 * pass_ms, "norm": 2 * pass_ms}
    out = dict(kernel_ms={k: v["kernel"] for k, v in ms.items()},
               plain_ms={k: v["plain"] for k, v in ms.items()},
               library_ms={k: v["library"] for k, v in ms.items()},
               bound_ms=bound,
               roofline={k: bound[k] / v["kernel"] for k, v in ms.items()})
    print("[add-layernorm] " + json.dumps(out), flush=True)
    return out


def swinir_times():
    """SwinIR's window attention (``csrc/window_attention.cu``) at
    SwinIR-L's widths (240, 8 heads of 30) on a 1024² map (the size of
    the SD cell's whole frames), shift 0 and 4: its ms in turns with the
    plain version and the library's, against its roofline (the q, k, v
    read and the output written at 3.35 TB/s); and SwinIR-L's whole bf16
    forward at 512² and 1024² through ``make_infer_fn``, with the
    attention and add-and-LayerNorm launches of those forwards."""
    import torch

    from super_resolution_tpu_torch.config import preset
    from super_resolution_tpu_torch.models.swinir import SwinIR
    from super_resolution_tpu_torch.ops import add_layernorm as aln
    from super_resolution_tpu_torch.ops import window_attention as wa
    from super_resolution_tpu_torch.train.steps import make_infer_fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    n = 1024
    qkv = torch.randn(1, n, n, 720, generator=gen,
                      device=dev).to(torch.bfloat16)
    table = torch.randn(8, 225, generator=gen, device=dev)
    ms = {}
    for shift in (0, 4):
        bias = wa.relative_bias(table)[None]
        if shift:
            bias = bias + wa.shift_mask(n, n, shift, dev)[:, None]
        bias = bias.expand(n * n // 64, -1, -1, -1).to(torch.bfloat16)
        ms[shift] = turns({
            "kernel": lambda: wa.window_attention(qkv, table, 8, shift),
            "plain": lambda: wa.window_attention_plain(qkv, table, 8,
                                                       shift),
            "library": lambda: window_attention_sdpa(qkv, 8, shift,
                                                     bias)}, 3)
        del bias
    del qkv
    torch.cuda.empty_cache()
    bound_ms = n * n * 4 * 240 * 2 / PEAK_BYTES * 1e3
    cfg = preset("swinir_l_real_x4")
    model = SwinIR(cfg.generator, torch.Generator().manual_seed(19))
    infer = make_infer_fn(cfg, model.state_dict(), dev)
    frames = {}
    launches = (wa.window_attention.launches, aln.add_layernorm.launches)
    for side in (512, 1024):
        x = torch.rand(1, side, side, 3, device=dev) - 0.45
        infer(x)
        frames[side] = time_ms(lambda: infer(x), 2)

    def mean(key):
        return (ms[0][key] + ms[4][key]) / 2

    out = dict(kernel_ms_1024={str(k): v["kernel"] for k, v in ms.items()},
               plain_ms_1024={str(k): v["plain"] for k, v in ms.items()},
               library_ms_1024={str(k): v["library"] for k, v in ms.items()},
               bound_ms_1024=bound_ms, roofline=bound_ms / mean("kernel"),
               forward_ms={str(k): v for k, v in frames.items()},
               launches_forward=wa.window_attention.launches - launches[0],
               add_layernorm_launches_forward=aln.add_layernorm.launches
               - launches[1],
               ms=mean("kernel"), plain_ms=mean("plain"),
               library_ms=mean("library"))
    print("[swinir] " + json.dumps(out), flush=True)
    return out


def bwd_times():
    """The backward kernels at the training shape, bf16: the wrapper
    against the plain backward and autograd through five cuDNN convs,
    and the kernels' own device time."""
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.dense_block import (
        dense_block,
        dense_block_bwd,
        plain_backward,
    )

    x, ws, ws_oihw, _, bs = card_block(TRAIN_SHAPE, 32, torch.bfloat16,
                                       100)
    g = torch.randn(TRAIN_SHAPE, generator=torch.Generator().manual_seed(
        200)).to("cuda", torch.bfloat16)
    kw = dict(res_scale=0.2, slope=0.2)
    with no_tf32():
        with torch.no_grad():
            _, feats = dense_block(x, ws, bs, save_acts=True, **kw)
        # the library yardstick: autograd through five cuDNN convs and
        # torch.cat in the working dtype, backward only (the graph is
        # built once and kept); never called by the port
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, *ws_oihw, *(bk.to(x.dtype) for bk in bs))]
        f_ = leaves[0]
        for k in range(4):
            o = F.leaky_relu(F.conv2d(f_, leaves[1 + k], leaves[6 + k],
                                      padding=1), 0.2)
            f_ = torch.cat([f_, o], 1)
        y_lib = leaves[0] + 0.2 * F.conv2d(f_, leaves[5], leaves[10],
                                           padding=1)
        fns = {"kernel": lambda: dense_block_bwd(feats, ws, g, **kw),
               "plain": lambda: plain_backward(feats, ws, g, **kw),
               "library": lambda: torch.autograd.grad(
                   y_lib, leaves, g, retain_graph=True)}
        with torch.no_grad():
            res = timed(fns, 20, bwd_bound(TRAIN_SHAPE, 32, "bfloat16"),
                        shape=list(TRAIN_SHAPE), growth=32,
                        dtype="bfloat16", slope=0.2)
            # the launches of one call, counted
            before = dense_block_bwd.launches
            fns["kernel"]()
            torch.cuda.synchronize()
            res["launches"] = dense_block_bwd.launches - before
            # the wrapper's time above includes its eager glue and is
            # bound by the host at these sizes; the kernels alone:
            res["kernels_device_ms"] = own_device_ms(fns["kernel"])
    print("[kernel-bwd] " + json.dumps({"train": res}), flush=True)
    return res


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
    from super_resolution_tpu_torch.bench import SEED_INIT
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

    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "g.pth")
        torch.save(rrdb.RRDBNet(GeneratorConfig(init=SEED_INIT),
                           torch.Generator().manual_seed(1)).state_dict(), pth)
        sd_serve = torch.load(pth, weights_only=True)
        watch, out_dir = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(watch)
        frames = {"a": rgba_frame(520, 820, rng),
                  "b": rgba_frame(300, 400, rng)}
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
    # its weights, for the eval, export and halo-parity phases
    return res, sd_serve


def train_phase(ck_dir=None):
    """``ck_dir``: where ``cli train`` writes its checkpoint directory, so
    that later phases can read it (default: inside the phase's own
    temporary directory)."""
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
        ck, log = ck_dir or os.path.join(tmp, "ck"), os.path.join(tmp, "log")
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


# [eval]: cli eval through the dense-block kernel against the same eval
# through the plain dense block on the card, per metric (bf16, 23
# blocks): PSNR within EVAL_PLAIN_PSNR_DB, SSIM within this (rounding
# flips move an SSIM by far less; a fault moves whole regions)
EVAL_PLAIN_SSIM = 1e-3
# the metrics on CUDA tensors against the same call on CPU tensors: both
# float32 without TF32 (E[x^2] - mu^2 under TF32 moves SSIM by ~1e-3)
EVAL_METRIC_DEVICE_TOL = 1e-5
# HR frames of the eval phase (H, W): one square, one non-square, one
# whose LR sides (101 x 181) are not multiples of 8
EVAL_FRAMES = {"a": (512, 512), "b": (480, 640), "c": (404, 724)}
EVAL_TILE, EVAL_TILE_BATCH = 96, 2


def cli_said(argv):
    """(rc, stdout) of ``cli.main(argv)``, the output echoed."""
    import contextlib
    import io

    from super_resolution_tpu_torch import cli

    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = cli.main(argv)
    print(said.getvalue(), end="", flush=True)
    return rc, said.getvalue()


def cli_json(argv):
    """(rc, the last stdout line of ``cli.main(argv)`` parsed as JSON)."""
    rc, out = cli_said(argv)
    return rc, json.loads(out.strip().splitlines()[-1])


def eval_phase(sd, work, smi):
    """``cli eval`` of the full-width generator (the serve phase's seeded
    weights ``sd``, bf16, ``auto``) over three synthetic HR frames written
    into ``work/val`` (kept for the export phase), and over a paired LR
    directory; see the module docstring."""
    import numpy as np
    import torch
    from PIL import Image

    from super_resolution_tpu_torch.config import GeneratorConfig, TrainConfig
    from super_resolution_tpu_torch.metrics import eval_metrics
    from super_resolution_tpu_torch.ops.dense_block import (
        LAUNCHES_PER_BLOCK,
        dense_block,
    )
    from super_resolution_tpu_torch.parallel.tiling import plan_tiles
    from super_resolution_tpu_torch.train.evaluate import evaluate_directory
    from super_resolution_tpu_torch.train.steps import make_infer_fn

    gcfg = GeneratorConfig()
    per_forward = gcfg.n_blocks * gcfg.n_dense * LAUNCHES_PER_BLOCK
    rng = np.random.default_rng(3)

    def frame(h, w):
        yy, xx = np.mgrid[0:h, 0:w]
        rgb = np.stack([xx * 255 // w, yy * 255 // h,
                        128 + 90 * np.sin(xx / 7.0) * np.cos(yy / 11.0)], -1)
        return np.clip(rgb + rng.integers(-12, 13, rgb.shape), 0,
                       255).astype(np.uint8)

    val, pdir = os.path.join(work, "val"), os.path.join(work, "paired")
    pth = os.path.join(work, "g_serve.pth")
    torch.save(sd, pth)
    os.makedirs(val)
    os.makedirs(os.path.join(pdir, "hr"))
    os.makedirs(os.path.join(pdir, "lr"))
    batches = 0
    for k, (h, w) in EVAL_FRAMES.items():
        hr = frame(h, w)
        Image.fromarray(hr).save(os.path.join(val, f"{k}.png"))
        _, oys, oxs = plan_tiles(h // 4, w // 4, EVAL_TILE, 8)
        batches += math.ceil(len(oys) * len(oxs) / EVAL_TILE_BATCH)
    # the paired frame: b's HR and a PIL-bicubic LR of it
    hr_b = frame(*EVAL_FRAMES["b"])
    Image.fromarray(hr_b).save(os.path.join(pdir, "hr", "b.png"))
    Image.fromarray(hr_b).resize((160, 120), Image.BICUBIC).save(
        os.path.join(pdir, "lr", "b.png"))

    argv = ["eval", "--dataset_dir", val, "--checkpoint", pth, "--json",
            "--tile", str(EVAL_TILE), "--tile_batch", str(EVAL_TILE_BATCH)]
    runs = []
    for _ in range(2):          # the second run is the warm one timed
        dense_block.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, got = cli_json(argv)
        runs.append(time.perf_counter() - t0)
        launches = dense_block.launches
        if rc != 0:
            fail(f"cli eval returned {rc}")
    if set(got) != {"psnr_rgb", "psnr_y", "ssim", "n_images"} \
            or got["n_images"] != len(EVAL_FRAMES) \
            or not all(math.isfinite(v) for v in got.values()):
        fail(f"cli eval printed {got}")
    want = batches * per_forward
    print(f"[eval] dense-block launches in one cli eval: {launches} (want "
          f"{batches} tile batches x {per_forward} = {want})", flush=True)
    if launches != want:
        fail("cli eval did not run every tile batch through the "
             "dense-block kernel")

    with PlainKernels():
        rc, plain = cli_json(argv)
    if rc != 0:
        fail(f"cli eval through the plain dense block returned {rc}")
    delta = {k: abs(got[k] - plain[k]) for k in ("psnr_rgb", "psnr_y",
                                                "ssim")}
    print(f"[eval] kernel vs plain dense block: |delta| {json.dumps(delta)}"
          f" (limits {EVAL_PLAIN_PSNR_DB} dB, SSIM {EVAL_PLAIN_SSIM})",
          flush=True)
    if delta["psnr_rgb"] > EVAL_PLAIN_PSNR_DB or \
            delta["psnr_y"] > EVAL_PLAIN_PSNR_DB or \
            delta["ssim"] > EVAL_PLAIN_SSIM:
        fail("cli eval through the kernel differs from the plain block")

    # the metrics on the card with cuDNN's TF32 default left on: the
    # SSIM filter must run without it
    a = torch.from_numpy(hr_b.astype(np.float32) / 255.0)
    b = torch.clamp(a + 0.03 * torch.randn(
        a.shape, generator=torch.Generator().manual_seed(4)), 0.0, 1.0)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        on_card = eval_metrics(a.cuda(), b.cuda())
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    on_cpu = eval_metrics(a, b)
    dev_err = {k: abs(float(on_card[k]) - float(v))
               for k, v in on_cpu.items()}
    print(f"[eval] metrics on CUDA vs CPU tensors: |delta| "
          f"{json.dumps(dev_err)} (limit {EVAL_METRIC_DEVICE_TOL})",
          flush=True)
    if max(dev_err.values()) > EVAL_METRIC_DEVICE_TOL:
        fail("ssim / psnr01 on the card differ from the CPU")

    dense_block.launches = 0
    rc, ens = cli_json(argv + ["--self_ensemble", "--max_images", "1"])
    _, oys, oxs = plan_tiles(EVAL_FRAMES["a"][0] // 4,
                             EVAL_FRAMES["a"][1] // 4, EVAL_TILE, 8)
    want_ens = 8 * math.ceil(len(oys) * len(oxs) / EVAL_TILE_BATCH) \
        * per_forward
    if rc != 0 or ens["n_images"] != 1 or dense_block.launches != want_ens \
            or not all(math.isfinite(v) for v in ens.values()):
        fail(f"cli eval --self_ensemble: rc {rc}, {ens}, launches "
             f"{dense_block.launches} (want {want_ens})")
    rc, paired = cli_json(["eval", "--dataset_dir",
                              os.path.join(pdir, "hr"), "--lr_dir",
                              os.path.join(pdir, "lr"), "--checkpoint", pth,
                              "--json"])
    if rc != 0 or paired["n_images"] != 1 or \
            not all(math.isfinite(v) for v in paired.values()):
        fail(f"cli eval --lr_dir: rc {rc}, {paired}")

    # where the call's time goes: the device's share, and the eval
    # itself with the generator built once (as the in-loop eval runs)
    profile_device(lambda: cli_said(argv), runs[1] * 1e3, "eval-profile")
    cfg = TrainConfig(generator=gcfg)
    infer = make_infer_fn(cfg, sd, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = evaluate_directory(cfg, None, val, tile=EVAL_TILE, halo=8,
                               tile_batch=EVAL_TILE_BATCH, infer_fn=infer)
    eval_only_s = time.perf_counter() - t0
    if again != got:
        fail(f"evaluate_directory with a built forward gave {again}, "
             f"cli eval {got}")

    out_mp = sum(h * w for h, w in EVAL_FRAMES.values()) / 1e6
    res = dict(metrics=got, plain=plain, kernel_vs_plain=delta,
               metrics_cuda_vs_cpu=dev_err, self_ensemble=ens, paired=paired,
               launches=launches, tile_batches=batches,
               first_run_s=runs[0], s=runs[1],
               s_per_image=runs[1] / len(EVAL_FRAMES),
               output_mp_per_s=out_mp / runs[1],
               built_forward_s_per_image=eval_only_s / len(EVAL_FRAMES))
    print(f"[eval] {smi}: cli eval of {len(EVAL_FRAMES)} images "
          f"({out_mp:.4f} output MP; 23 blocks, bf16, auto, tile "
          f"{EVAL_TILE}, halo 8, tile batch {EVAL_TILE_BATCH}): "
          f"{res['s_per_image']:.4f} s per image, "
          f"{res['output_mp_per_s']:.4f} output MP/s (warm run; the first "
          f"run {runs[0]:.3f} s); with the generator built once (in-loop "
          f"eval) {res['built_forward_s_per_image']:.4f} s per image",
          flush=True)
    print("[eval] " + json.dumps(res), flush=True)
    return res


def export_phase(ck, work, serve_sd, smi):
    """``cli export`` of the train phase's checkpoint directory ``ck``
    with the default halo sweep and ``--val_dir`` (the eval phase's
    images), the stamp read by ``cli upscale --halo auto``, the release
    against the directory in ``cli upscale``, ``--ema``, and ``cli
    interp`` of the release with the serve phase's weights."""
    import numpy as np
    import torch
    from PIL import Image

    import super_resolution_tpu_torch.halo_sweep as hs
    from super_resolution_tpu_torch.checkpoint import restore_generator_trees
    from super_resolution_tpu_torch.import_torch import (
        import_generator,
        load_pth,
    )

    rel = os.path.join(work, "release.pth")
    sweep_s = []
    orig_sweep = hs.sweep_admissible_halo

    def timed_sweep(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_sweep(*a, **kw)
        torch.cuda.synchronize()
        sweep_s.append(time.perf_counter() - t0)
        return out

    hs.sweep_admissible_halo = timed_sweep
    try:
        t0 = time.perf_counter()
        rc, said = cli_said(
            ["export", "--checkpoint", ck, "--out", rel, "--val_dir",
             os.path.join(work, "val")])
        export_s = time.perf_counter() - t0
    finally:
        hs.sweep_admissible_halo = orig_sweep
    if rc != 0 or "EMA maturity horizon" not in said:
        fail(f"cli export returned {rc} or did not gate the step-6 EMA")
    meta = hs.read_halo_meta(rel)
    row_keys = {"halo", "psnr_vs_whole_db", "max_err01", "mean_err01",
                "uint8_lsb_max"}
    if meta is None or meta.get("method") != "structured_probe_sweep" \
            or [r["halo"] for r in meta["sweep"]] != [2, 4, 6, 8] \
            or any(set(r) != row_keys for r in meta["sweep"]) \
            or (meta["frame"], meta["tile_w"]) != (192, 64) \
            or meta["weights"] != "params":
        fail(f"the release sidecar is wrong: {meta}")
    halo = meta["admissible_halo"]
    vc = meta.get("val_contract")
    if halo is not None and (vc is None or vc["n_images"] != 3 or
                             not math.isfinite(vc["delta_db"])):
        fail(f"the sidecar's val contract is wrong: {vc}")
    print(f"[export] {smi}: halo sweep (fp32 lax, TF32 off, frame 192, "
          f"tile_w 64, halos 2,4,6,8, 23 blocks) {sweep_s[0]:.3f} s; cli "
          f"export with it and the val contract {export_s:.3f} s; "
          f"admissible_halo {halo}; sweep "
          f"{json.dumps([(r['halo'], r['psnr_vs_whole_db']) for r in meta['sweep']])};"
          f" val contract {json.dumps(vc)}", flush=True)

    # the release and the checkpoint directory give the same bytes
    rng = np.random.default_rng(5)
    src = os.path.join(work, "lr_export.png")
    Image.fromarray(rng.integers(0, 256, (150, 260, 3), dtype=np.uint8)) \
        .save(src)
    outs = {}
    for name, ckpt, halo_flag in (("release", rel, "auto"),
                                  ("dir", ck, str(8 if halo is None
                                                  else halo))):
        outs[name] = os.path.join(work, f"sr_{name}.png")
        rc, said = cli_said(
            ["upscale", "--image", src, "--checkpoint", ckpt, "--out",
             outs[name], "--tile", "96", "--halo", halo_flag])
        if rc != 0:
            fail(f"cli upscale from the {name} returned {rc}")
        if name == "release":
            line = (f"halo={halo} from release metadata" if halo is not None
                    else "found NO admissible halo")
            if line not in said:
                fail(f"cli upscale --halo auto did not read the stamp "
                     f"({line!r})")
    same = np.array_equal(np.asarray(Image.open(outs["release"])),
                          np.asarray(Image.open(outs["dir"])))
    print(f"[export] cli upscale from the release vs the checkpoint "
          f"directory: same bytes {same}", flush=True)
    if not same:
        fail("the release .pth upscales differently from its checkpoint")

    rel_ema = os.path.join(work, "release_ema.pth")
    rc, _ = cli_said(["export", "--checkpoint", ck, "--out",
                               rel_ema, "--ema", "--no-halo_sweep"])
    tree = torch.load(rel_ema, weights_only=True)
    _, g_ema, _ = restore_generator_trees(ck)
    if rc != 0 or set(tree) != {"params", "params_ema"} or not torch.equal(
            tree["params_ema"]["conv_first.weight"],
            g_ema["conv_first.weight"]):
        fail("cli export --ema did not write {params, params_ema}")

    serve_pth = os.path.join(work, "g_serve.pth")
    psnr_side, _ = import_generator(load_pth(rel))
    gan_side, _ = import_generator(serve_sd)
    interp = {}
    for alpha in (0.0, 1.0, 0.5):
        out = os.path.join(work, f"interp_{alpha}.pth")
        rc, _ = cli_said(["interp", "--psnr_ckpt", rel,
                                   "--gan_ckpt", serve_pth, "--alpha",
                                   str(alpha), "--out", out])
        got, _ = import_generator(load_pth(out))
        if rc != 0:
            fail(f"cli interp alpha {alpha} returned {rc}")
        if alpha == 0.5:
            interp[alpha] = max(float((got[k] - 0.5 * (psnr_side[k]
                                                       + gan_side[k]))
                                      .abs().max()) for k in got)
            ok = interp[alpha] <= 1e-6
        else:
            side = psnr_side if alpha == 0.0 else gan_side
            ok = interp[alpha] = all(torch.equal(got[k], side[k])
                                     for k in got)
        if not ok:
            fail(f"cli interp alpha {alpha}: {interp[alpha]}")
    print(f"[export] cli interp of the release and the serve weights: alpha "
          f"0 equals the PSNR side {interp[0.0]}, alpha 1 the GAN side "
          f"{interp[1.0]}, alpha 0.5 max |err| from the mean "
          f"{interp[0.5]:.3g} (limit 1e-6)", flush=True)
    return dict(sweep_s=sweep_s[0], export_s=export_s, meta=meta)


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


def conv3x3_times():
    """The single-conv kernel at the flagship tail's shapes (conv_impl
    pallas_cf_tail) and at conv_first, conv_last and the pixel-shuffle
    upconv (conv_impl pallas), batch 8 of 128² LR tiles, bf16 (the
    library: one cuDNN conv with its bias, no activation)."""
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
    from super_resolution_tpu_torch.ops.dense_block import (
        pack_weight,
        unpack_weight,
    )

    cases = [  # name, NHWC x, cout, LeakyReLU slope or None
        ("conv_body_128", (8, 128, 128, 64), 64, None),
        ("upconv1_256", (8, 256, 256, 64), 64, 0.2),
        ("hr_conv_512", (8, 512, 512, 64), 64, 0.2),
        ("conv_first", (8, 128, 128, 3), 64, None),
        ("conv_last", (8, 512, 512, 64), 3, None),
        ("upconv_ps", (8, 128, 128, 64), 256, 0.2),
    ]
    results = {}
    for name, shape, cout, slope in cases:
        gen = torch.Generator().manual_seed(300 + len(results))
        cin = shape[-1]
        x = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
        w = pack_weight(torch.randn(cout, cin, 3, 3, generator=gen)
                        * math.sqrt(2.0 / (9 * cin))).to("cuda",
                                                         torch.bfloat16)
        b = (torch.randn(cout, generator=gen) * 0.1).cuda()
        w_oihw, b_lib = unpack_weight(w).contiguous(), b.to(torch.bfloat16)
        x_cl = x.permute(0, 3, 1, 2)          # NCHW view, channels-last
        kw = dict(act=slope is not None, slope=slope or 0.2)
        with torch.inference_mode(), no_tf32():
            results[name] = timed(
                {"kernel": lambda: conv3x3(x, w, b, **kw),
                 "plain": lambda: conv3x3_plain(x, w, b, **kw),
                 "library": lambda: F.conv2d(x_cl, w_oihw, b_lib,
                                             padding=1)},
                10 if shape[1] >= 512 else 20,
                conv_bound(shape, cout, "bfloat16"), shape=list(shape),
                cout=cout, dtype="bfloat16", act=kw["act"], slope=slope)
        print("[kernel-conv3x3] " + json.dumps({name: results[name]}),
              flush=True)
    return results


def fused_times():
    """The NHWC dense-block entry at the flagship block, bf16."""
    import torch

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.dense_block import (
        fused_dense_block,
        fused_dense_block_plain,
    )

    shape = (8, 64, 128, 128)
    x, ws, ws_oihw, _, bs = card_block(shape, 32, torch.bfloat16, 400)
    x = x.permute(0, 2, 3, 1).contiguous()           # NHWC
    x_cl = x.permute(0, 3, 1, 2)
    kw = dict(res_scale=0.2, slope=0.2)
    with torch.inference_mode(), no_tf32():
        res = timed({"kernel": lambda: fused_dense_block(x, ws, bs, **kw),
                     "plain": lambda: fused_dense_block_plain(x, ws, bs,
                                                              **kw),
                     # on the channels-last view
                     "library": lambda: cudnn_block(x_cl, ws_oihw, bs)},
                    20, block_bound(shape, 32, "bfloat16"),
                    shape_nhwc=list(x.shape), dtype="bfloat16")
    print("[kernel-fused] " + json.dumps({"flagship": res}), flush=True)
    return res


def experiments_times():
    """v3, v3b, v4 (with and without ``save_acts``) and v6, routed to
    the dense-block kernel, at the flagship block with their default
    band heights, bf16: the wrapper's ms (weight packing included)."""
    import torch

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops import experiments_dense_block as ex

    shape = (8, 64, 128, 128)
    results = {}
    for name, wrapper, kw in (
            ("cf_flagship", "fused_dense_block_cf", {}),
            ("cf2_flagship", "fused_dense_block_cf2", {}),
            ("cf3_flagship", "fused_dense_block_cf3", {}),
            ("cf3_save_acts", "fused_dense_block_cf3", {"save_acts": True}),
            ("cf6_flagship", "fused_dense_block_cf6", {})):
        fn = getattr(ex, wrapper)
        x, _, ws_oihw, ws, bs = card_block(shape, 32, torch.bfloat16,
                                           500 + len(results))
        with torch.inference_mode(), no_tf32():
            results[name] = timed(
                {"plain": lambda: ex.dense_block_plain(
                    x, *ex._packed(x, ws, bs), res_scale=0.2, slope=0.2),
                 "kernel": lambda: fn(x, ws, bs, **kw),
                 "library": lambda: cudnn_block(x, ws_oihw, bs)},
                20, block_bound(shape, 32, "bfloat16"), wrapper=wrapper,
                rows=fn.__kwdefaults__["rows"], shape=list(shape),
                dtype="bfloat16")
        print("[kernel-experiments] " + json.dumps({name: results[name]}),
              flush=True)
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


def int8_times():
    """v8's int8 kernels at the flagship block (rows 16 and 32, bf16) and
    at growth 8 in fp32: the wrapper's ms in turns with its plain version
    (cuDNN's bf16 block for scale: no PyTorch call computes this
    function), the kernels' device time alone and by kernel beside the
    bf16 dense block's in the same call, the int8 bound; and, where
    ``CHIP_SMOKE_PARENT`` names a checkout of an earlier commit, that
    commit's v8 on the same inputs, value for value."""
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
        x, wp, ws_oihw, ws, bs = card_block(shape, growth,
                                            getattr(torch, dtype_name), 600)
        inputs[name] = (x, ws, bs, rows)
        with torch.inference_mode(), no_tf32():
            before = fn.launches
            outs[name] = fn(x, ws, bs, rows=rows)
            torch.cuda.synchronize()
            per_call = fn.launches - before
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
        bound_ms, bound_by, ops, nbytes = int8_bound(shape, growth, rows,
                                                     dtype_name)
        results[name] = dict(
            shape=list(shape), growth=growth, rows=rows, dtype=dtype_name,
            launches_per_call=per_call, kernel_ms=ms["kernel"],
            kernels_device_ms=dev_ms,
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


# [train-dp]: data parallel training at full width (train_gan_dfm, 23
# blocks, global batch 16 of 192^2 HR, bf16)
DP_LOSS_ATOL, DP_PARAM_ATOL = 5e-4, 1e-3   # the JAX package's, test_dp.py
DP_LOSSES = ("loss_g", "loss_d", "loss_adv", "loss_pixel", "loss_percep")
DP_TIMED_STEPS = 3


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def merged_ms(events, pattern):
    """Host ms covered by the profiler's host events whose name matches
    ``pattern`` (a regex), nested ones counted once."""
    import re

    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CPU
                   and re.search(pattern, e.name))
    total, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


ALL_REDUCE = r"(?i)all_?reduce|nccl"


def dp_cfg(dedup):
    """train_gan_dfm at full width with the torch_default init: a freshly
    drawn msra_scaled G gives a near-constant SR image, on which D's
    batch statistics cancel and summation order alone moves the step."""
    from super_resolution_tpu_torch.bench import SEED_INIT
    from super_resolution_tpu_torch.config import preset

    cfg = preset("train_gan_dfm")
    return dataclasses.replace(cfg, dedup_d_hr=dedup,
                               generator=dataclasses.replace(
                                   cfg.generator, init=SEED_INIT))


def dp_gan_step(cfg, device, part):
    """One GAN step from the seeded initial state on rows ``part`` of the
    global batch: (CPU copy of metrics, parameters, D statistics; the
    state; the step)."""
    import torch

    from super_resolution_tpu_torch.data import SyntheticPatches
    from super_resolution_tpu_torch.train.state import init_state
    from super_resolution_tpu_torch.train.steps import make_gan_step

    state = init_state(cfg, device)
    step = make_gan_step(cfg)
    batch = torch.from_numpy(next(iter(SyntheticPatches(
        cfg.data, seed=123, part=part)))).to(device)
    metrics = step(state, batch)
    snap = {"metrics": {k: float(v) for k, v in metrics.items()},
            "g": {k: v.detach().cpu() for k, v in state.g.state_dict()
                  .items()},
            "d": {k: v.detach().cpu() for k, v in state.d.state_dict()
                  .items()}}
    return snap, state, step, batch


def timed_steps(step, state, batch, n):
    """ms of each of ``n`` steps (host clock around a synchronised
    step)."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def step_profile(step, state, batch, ms):
    """One step under torch.profiler: the all-reduces' host ms (and
    device ms of NCCL kernels), the device's busy ms, against the
    unprofiled ``ms`` per step."""
    import torch

    t0 = time.perf_counter()
    prof, by_name = device_times(lambda: step(state, batch))
    wall = (time.perf_counter() - t0) * 1e3
    busy = sum(by_name.values())
    nccl = sum(t for n, t in by_name.items() if "nccl" in n.lower())
    host = merged_ms(prof.events(), ALL_REDUCE)
    # the profiler slows the host's other ops more than the waits of the
    # all-reduces: the share of the profiled step is a lower bound, the
    # share of the unprofiled step an upper one
    return dict(profiled_step_ms=wall, all_reduce_host_ms=host,
                all_reduce_share_of_profiled_step=host / wall,
                all_reduce_share_of_step=host / ms,
                nccl_kernels_device_ms=nccl, device_busy_ms=busy,
                device_idle_share=max(0.0, 1 - busy / ms) if busy else None)


def dp_rank_main(device, out_dir):
    """One of [train-dp] (b)'s two gloo ranks on the one card: a GAN step
    of each shape on this rank's 8 rows, the launches they made, ms per
    step and one profiled step."""
    import torch

    from super_resolution_tpu_torch.parallel import dp

    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    part = (dp.rank(), dp.world_size())
    out = {}
    for dedup in (True, False):     # the default step shape timed last
        out[f"dedup{dedup}"], state, step, batch = dp_gan_step(
            dp_cfg(dedup), device, part)
    out["launches"] = {n: f.launches for n, f in counters.items()
                       if f.launches}
    times = timed_steps(step, state, batch, DP_TIMED_STEPS + 1)[1:]
    ms = sorted(times)[len(times) // 2]
    out["ms"], out["ms_runs"] = ms, times
    out["profile"] = step_profile(step, state, batch, ms)
    torch.save(out, os.path.join(out_dir, f"rank{dp.rank()}.pt"))


def trees_equal(a, b, path=""):
    """Paths where two nested trees of tensors and numbers differ."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path}: keys"]
        return [d for k in a for d in trees_equal(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in trees_equal(x, y, f"{path}[{i}]")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [path]
    return [] if a == b else [path]


def dp_distance(a, b):
    """(largest |loss delta|, largest |G or D parameter / statistic
    delta|) between two step snapshots."""
    loss = max(abs(a["metrics"][k] - b["metrics"][k]) for k in DP_LOSSES)
    param = max(float((a[t][k].float() - b[t][k].float()).abs().max())
                for t in ("g", "d") for k in b[t])
    return loss, param


def train_dp_phase():
    """(a) ``cli train --data_parallel 1 --multihost ...`` (NCCL, one
    rank) against the plain ``cli train``: bit for bit; (b) two gloo
    ranks on the one card with 8 rows each against one process with the
    16 rows, both step shapes, at the JAX package's tolerances; (c) the
    per-rank control must miss them.  ms per step, the all-reduce's
    share and the device's idle share."""
    import torch

    from super_resolution_tpu_torch.config import preset
    from super_resolution_tpu_torch.parallel import dp, multihost

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        common = ["train", "--preset", "train_gan_dfm", "--dataset_dir",
                  os.path.join(tmp, "no_dataset"), "--steps", "4",
                  "--warmup_batches", "2"]
        runs = {}
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True   # for the bit compare
        try:
            for name, extra in (("plain", []), ("nccl1", [
                    "--data_parallel", "1", "--multihost",
                    "--num_processes", "1", "--process_id", "0",
                    "--coordinator", f"127.0.0.1:{free_port()}"])):
                ck, log = (os.path.join(tmp, f"{name}_{d}")
                           for d in ("ck", "log"))
                rc, records, totals = cli_train_recorded(
                    [*common, "--checkpoint_dir", ck, "--log_dir", log,
                     *extra])
                if rc != 0 or dp.active():
                    fail(f"cli train ({name}) returned {rc}")
                tree = torch.load(os.path.join(ck, "4", "state.pt"),
                                  map_location="cpu", weights_only=True)
                with open(os.path.join(log, "metrics.jsonl")) as f:
                    logged = [json.loads(line) for line in f]
                for line in logged:     # a wall-clock rate, not a result
                    line.pop("mp_per_sec_per_chip")
                runs[name] = dict(records=records, totals=totals,
                                  tree=tree, logged=logged)
        finally:
            torch.backends.cudnn.deterministic = prev
        a, b = runs["plain"], runs["nccl1"]
        diffs = trees_equal(a["tree"], b["tree"])
        diffs += trees_equal([r["metrics"] for r in a["records"]],
                             [r["metrics"] for r in b["records"]], "steps")
        diffs += trees_equal(a["logged"], b["logged"], "metrics.jsonl")
        res["a"] = dict(
            bit_for_bit=not diffs, differing=diffs[:8],
            plain_step_ms=[r["ms"] for r in a["records"]],
            nccl1_step_ms=[r["ms"] for r in b["records"]],
            launches=b["totals"])
        print("[train-dp] (a) NCCL, one rank, vs plain cli train (2 warmup "
              "+ 2 GAN steps, cuDNN deterministic in both): "
              + json.dumps(res["a"]), flush=True)
        if diffs:
            fail(f"the one-rank NCCL run differs from the plain run in "
                 f"{diffs[:8]}")
        if b["totals"]["dense_block"] == 0 or \
                b["totals"]["dense_block_bwd"] == 0:
            fail("the data-parallel run launched no dense-block kernel")
        del runs, a, b

    # the all-reduce's cost under NCCL at world size 1, one profiled step
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        _, state, step, batch = dp_gan_step(dp_cfg(False), "cuda", (0, 1))
        times = timed_steps(step, state, batch, DP_TIMED_STEPS)
        ms = sorted(times)[len(times) // 2]
        res["nccl1"] = dict(ms=ms, ms_runs=times,
                            **step_profile(step, state, batch, ms))
        del state
    finally:
        torch.distributed.destroy_process_group()
    print("[train-dp] NCCL, one rank, GAN step: " + json.dumps(
        res["nccl1"]), flush=True)

    # (b) two ranks on the one card over gloo, 8 rows each
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dp.launch(dp_rank_main, (tmp,), ["cuda:0", "cuda:0"],
                  init_method=f"file://{tmp}/store", timeout_s=600)
        launch_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    b = dict(launch_s=launch_s, launches_per_rank=[r["launches"]
                                                   for r in ranks],
             ms_per_rank=[r["ms"] for r in ranks],
             ms_runs_per_rank=[r["ms_runs"] for r in ranks],
             profile_per_rank=[r["profile"] for r in ranks])
    busy = [r["profile"]["device_busy_ms"] for r in ranks]
    b["card_idle_share"] = max(0.0, 1 - sum(busy) / max(b["ms_per_rank"])) \
        if all(busy) else None
    gcfg = preset("train_gan_dfm").generator
    n_fwd = gcfg.n_blocks * gcfg.n_dense * 5
    for dedup in (False, True):
        ref, _, _, _ = dp_gan_step(dp_cfg(dedup), "cuda", (0, 1))
        ctl, _, _, _ = dp_gan_step(dp_cfg(dedup), "cuda", (0, 2))
        got = ranks[0][f"dedup{dedup}"]
        loss, param = dp_distance(got, ref)
        c_loss, c_param = dp_distance(ctl, ref)
        same = not trees_equal({k: got[k] for k in ("g", "d", "metrics")},
                               {k: ranks[1][f"dedup{dedup}"][k]
                                for k in ("g", "d", "metrics")})
        b[f"dedup{dedup}"] = dict(
            loss_delta=loss, param_delta=param, ranks_equal=same,
            control_loss_delta=c_loss, control_param_delta=c_param,
            losses={k: [got["metrics"][k], ref["metrics"][k]]
                    for k in DP_LOSSES})
        print(f"[train-dp] (b) two gloo ranks on one card vs one process, "
              f"dedup_d_hr={dedup} (tolerances: losses {DP_LOSS_ATOL}, "
              f"parameters and statistics {DP_PARAM_ATOL}); (c) the "
              f"per-rank control: " + json.dumps(b[f"dedup{dedup}"]),
              flush=True)
        if not (loss <= DP_LOSS_ATOL and param <= DP_PARAM_ATOL):
            fail(f"two ranks differ from one process (dedup_d_hr={dedup}):"
                 f" losses {loss}, parameters {param}")
        if not same:
            fail(f"the two ranks ended unequal (dedup_d_hr={dedup})")
        if c_loss <= DP_LOSS_ATOL and c_param <= DP_PARAM_ATOL:
            fail(f"the per-rank control is within the tolerances "
                 f"(dedup_d_hr={dedup}): the check cannot fail")
    if any(r["launches"].get("dense_block", 0) < 2 * n_fwd
           or not r["launches"].get("dense_block_bwd") for r in ranks):
        fail(f"a rank did not launch the dense-block kernels: "
             f"{b['launches_per_rank']}")
    res["b"] = b
    print("[train-dp] (b) " + json.dumps(b), flush=True)
    return res


def profile_dir_phase():
    """``cli train --profile_dir D``, one warmup and one GAN step at a
    depth of 2 blocks: a trace in D that names the dense-block kernels
    (forward on the Hopper tile, and the backward's)."""
    with tempfile.TemporaryDirectory() as tmp:
        pdir = os.path.join(tmp, "trace")
        t0 = time.perf_counter()
        rc, _, totals = cli_train_recorded(
            ["train", "--preset", "train_gan_dfm", "--residual_blocks",
             "2", "--dataset_dir", os.path.join(tmp, "no_dataset"),
             "--steps", "2", "--warmup_batches", "1", "--checkpoint_dir",
             os.path.join(tmp, "ck"), "--profile_dir", pdir])
        secs = time.perf_counter() - t0
        traces = [n for n in os.listdir(pdir)
                  if n.endswith(".pt.trace.json")] \
            if os.path.isdir(pdir) else []
        if rc != 0 or len(traces) != 1:
            fail(f"cli train --profile_dir: rc {rc}, traces {traces}")
        path = os.path.join(pdir, traces[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = {}
        for e in events:
            if e.get("cat") == "kernel":
                kernels[e["name"]] = kernels.get(e["name"], 0.0) \
                    + e.get("dur", 0) / 1e3
        named = {k: sum(t for n, t in kernels.items() if k in n)
                 for k in ("conv3x3_wgmma", "bwd_prep", "wgrad_wgmma",
                           "bwd_reduce")}
        res = dict(s=secs, trace_mb=os.path.getsize(path) / 1e6,
                   kernel_names=len(kernels), dense_block_kernels_ms=named,
                   launches=totals)
    print("[profile-dir] " + json.dumps(res), flush=True)
    if not all(named.values()):
        fail(f"the trace does not name every dense-block kernel: {named}")
    return res


def build_cache_phase():
    """``cli upscale --conv_impl pallas --compile_cache_dir <fresh>`` at a
    depth of 2 blocks, twice, each a process of its own with an ``nvcc``
    on its PATH that logs each start: the first builds conv3x3's library
    into the directory, the second starts no nvcc."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    import super_resolution_tpu_torch.models.rrdb as rrdb
    from super_resolution_tpu_torch import build
    from super_resolution_tpu_torch.bench import SEED_INIT
    from super_resolution_tpu_torch.config import GeneratorConfig

    real = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        shim, log = os.path.join(tmp, "bin"), os.path.join(tmp, "nvcc.log")
        os.makedirs(shim)
        with open(os.path.join(shim, "nvcc"), "w") as f:
            f.write(f'#!/bin/sh\necho "$*" >> {log}\nexec {real} "$@"\n')
        os.chmod(os.path.join(shim, "nvcc"), 0o755)
        pth, src = os.path.join(tmp, "g.pth"), os.path.join(tmp, "lr.png")
        torch.save(rrdb.RRDBNet(GeneratorConfig(n_blocks=2, init=SEED_INIT),
                                torch.Generator().manual_seed(0))
                   .state_dict(), pth)
        Image.fromarray(np.random.default_rng(3).integers(
            0, 256, (96, 128, 3), dtype=np.uint8)).save(src)
        cache = os.path.join(tmp, "cache")
        env = dict(os.environ, PYTHONPATH=HERE,
                   PATH=shim + os.pathsep + os.environ.get("PATH", ""))
        runs = []
        for i in range(2):
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "super_resolution_tpu_torch.cli",
                 "upscale", "--image", src, "--checkpoint", pth, "--out",
                 os.path.join(tmp, f"sr{i}.png"), "--conv_impl", "pallas",
                 "--compile_cache_dir", cache], env=env, cwd=tmp,
                capture_output=True, text=True, timeout=600)
            nvcc = open(log).read().splitlines() if os.path.exists(log) \
                else []
            runs.append(dict(rc=p.returncode,
                             s=time.perf_counter() - t0, nvcc_starts=len(nvcc),
                             cache=sorted(os.listdir(cache))
                             if os.path.isdir(cache) else []))
            if p.returncode != 0:
                print(p.stdout[-3000:] + p.stderr[-3000:], flush=True)
        lib = os.path.basename(build.library_path("conv3x3"))
    res = dict(first=runs[0], second=runs[1], library=lib)
    print("[build-cache] " + json.dumps(res), flush=True)
    if runs[0]["rc"] != 0 or runs[1]["rc"] != 0:
        fail(f"cli upscale --compile_cache_dir failed: {res}")
    if runs[0]["nvcc_starts"] != 1 or lib not in runs[0]["cache"]:
        fail(f"the first call did not build conv3x3 into the cache: {res}")
    if runs[1]["nvcc_starts"] != 1:
        fail(f"the second call started nvcc: {res}")
    return res


# ---------------------------------------------------------------------------
# The last slice's tools, each a subprocess of the card (``run_tool``)


def tool_launches(out):
    """The ``launches: {...}`` line a tool ends with, parsed."""
    return json.loads(out.rstrip().splitlines()[-1].split("launches: ", 1)[1])


def grain_phase():
    """``cli train --loader grain``.  Without the grain package (this
    machine's case) a nonzero exit whose message names grain, and no
    step taken, never the threaded loader in its place; with it, 2 + 2
    steps at 2 blocks and a resume equal bit for bit to a straight run."""
    import importlib.util

    import numpy as np
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        rng = np.random.default_rng(11)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (64, 64, 3),
                                         dtype=np.uint8)).save(
                os.path.join(data, f"i{i}.png"))
        argv = ["train", "--loader", "grain", "--dataset_dir", data,
                "--preset", "train_gan_dfm", "--residual_blocks", "2",
                "--batch_size", "4", "--hr_height", "32", "--n_cpu", "0",
                "--warmup_batches", "2"]
        if importlib.util.find_spec("grain") is None:
            ck = os.path.join(tmp, "ck")
            p = subprocess.run(
                [sys.executable, "-m", "super_resolution_tpu_torch.cli",
                 *argv, "--steps", "2", "--checkpoint_dir", ck], cwd=HERE,
                capture_output=True, text=True, timeout=300)
            res = dict(grain=False, rc=p.returncode,
                       message=p.stderr.strip().splitlines()[-1:],
                       stepped="] warmup step" in p.stdout
                       or "[gan step" in p.stdout,
                       checkpoint_dir=os.path.exists(ck))
            print("[grain] " + json.dumps(res), flush=True)
            if p.returncode == 0 or "grain" not in p.stderr \
                    or res["stepped"] or res["checkpoint_dir"]:
                fail(f"--loader grain without grain did not refuse: {res}")
            return res
        import torch

        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True     # for the bit compare
        try:
            a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
            rcs = [cli_train_recorded(argv + x)[0] for x in (
                ["--steps", "2", "--checkpoint_dir", a],
                ["--steps", "4", "--checkpoint_dir", a, "--resume"],
                ["--steps", "4", "--checkpoint_dir", b])]
        finally:
            torch.backends.cudnn.deterministic = prev
        load = lambda d: torch.load(os.path.join(d, "4", "state.pt"),  # noqa
                                    map_location="cpu", weights_only=True)
        diff = trees_equal(load(a), load(b))
        res = dict(grain=True, rcs=rcs, differing=diff[:8])
        print("[grain] " + json.dumps(res), flush=True)
        if any(rcs) or diff:
            fail(f"cli train --loader grain: {res}")
        return res


def convert_vgg_phase():
    """``tools.convert_vgg`` on a seeded synthetic VGG-19 state dict with
    torchvision's key names; the port's VGG features from the npz on the
    card in float32 (TF32 off) against the CPU within 1e-4 of the largest
    feature (``tests/test_parity.py``'s VGG tolerance)."""
    import numpy as np
    import torch

    from super_resolution_tpu_torch.config import VGGConfig
    from super_resolution_tpu_torch.models.vgg import (
        VGGFeatures,
        load_vgg_params,
    )

    gen = torch.Generator().manual_seed(19)
    sd, idx, cin = {}, 0, 3
    for item in VGGConfig().arch:
        if item == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.randn(
            item, cin, 3, 3, generator=gen) * (2.0 / (9 * cin)) ** 0.5
        sd[f"features.{idx}.bias"] = torch.randn(item, generator=gen) * 0.01
        idx, cin = idx + 2, item          # conv, ReLU
    with tempfile.TemporaryDirectory() as tmp:
        pth, npz = os.path.join(tmp, "vgg19.pth"), os.path.join(tmp, "v.npz")
        torch.save(sd, pth)
        run_tool("convert_vgg", [pth, npz], 300)
        weights = load_vgg_params(npz)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, 64, 64, 3), dtype=np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        vgg = VGGFeatures()
        vgg.load_state_dict(weights, strict=True)
        with torch.no_grad():       # the trunk runs its convs TF32-off
            outs[dev] = vgg.to(dev)(x.to(dev)).cpu()
    scale = float(outs["cpu"].abs().max())
    err = float((outs["cuda"] - outs["cpu"]).abs().max()) / scale
    res = dict(convs=len(weights) // 2, max_rel_err=err,
               shape=list(outs["cuda"].shape))
    print("[convert-vgg] " + json.dumps(res), flush=True)
    if res["convs"] != 16 or not err <= 1e-4:
        fail(f"convert_vgg: {res}")
    return res


def grad_bench_phase():
    """``tools.grad_bench`` at its defaults, (16, 64, 48²) bf16: ms of
    lax and kernel, ``kernel_fold`` not ported, launches by the
    formulas.  Then, on the tool's seeded inputs in this process, the
    backward kernels' dx against the plain backward's from the same
    saved buffer and cotangent within 2^-6 of the largest |dx| (the bf16
    backward's bound, PERF.md section 2), and for the record the dx of
    the whole forward + backward through the kernels, the plain block
    and cuDNN's bf16 autograd, each against the others and against the
    float32 dx of the same bf16 values: a bf16 activation that rounds
    the other way in one forward moves the cotangent and dx through
    every later conv, so those differ by about as much as each differs
    from float32.  The kernels' and the plain block's distances from the
    float32 dx are held to (1 + ``GRAD_BENCH_F32_DELTA``) times cuDNN's."""
    import importlib
    import re

    import torch

    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.ops.dense_block import (
        bwd_launches,
        dense_block_train,
        fwd_launches,
    )
    from super_resolution_tpu_torch.ops.experiments_dense_block import _packed
    from super_resolution_tpu_torch.tools.grad_bench import dx_of, make_inputs
    from super_resolution_tpu_torch.tools.kernel_bench import lax_block

    out = run_tool("grad_bench", [], 600)
    ms = {}
    for v in ("lax", "kernel"):
        m = re.search(rf"^{v}\s+:\s+([\d.]+) ms\s+([\d.]+) TF/s", out, re.M)
        if not m:
            fail(f"grad_bench printed no time for {v}")
        ms[v] = float(m.group(1))
    m = re.search(r"dx maxerr vs lax (\S+) of max \|dx\| (\S+)$", out, re.M)
    if not m or not re.search(r"^kernel_fold : .*not ported", out, re.M):
        fail("grad_bench: no dx comparison or no kernel_fold line")
    launches = tool_launches(out)
    calls = launches["dense_block"] // fwd_launches(5)

    ops = importlib.import_module("super_resolution_tpu_torch.ops.dense_block")
    x, tgt, ws, bs = make_inputs(16, 48, 48, torch.device("cuda"))
    wp, bp = _packed(x, ws, bs)

    def kernel_block(a):
        return dense_block_train(a, wp, bp, res_scale=0.2, slope=0.2)

    # the backward alone, both from the kernel forward's saved buffer
    # and the L2 loss's cotangent: the bound's own comparison
    y, feats = ops.dense_block(x, wp, bp, res_scale=0.2, slope=0.2,
                               save_acts=True)
    g = (2.0 * (y.float() - tgt)).to(x.dtype)
    bwd = {name: fn(feats, wp, g, res_scale=0.2, slope=0.2)[0].float()
           for name, fn in (("kernel", ops.dense_block_bwd),
                            ("plain", ops.plain_backward))}
    bwd_big = float(bwd["plain"].abs().max())
    dx = {"kernel": dx_of(kernel_block, x, tgt).float(),
          "lax": dx_of(lambda a: lax_block(a, ws, bs), x, tgt).float()}
    orig = ops.dense_block, ops.dense_block_bwd
    ops.dense_block, ops.dense_block_bwd = ops.plain_forward, \
        ops.plain_backward
    try:
        dx["plain"] = dx_of(kernel_block, x, tgt).float()
    finally:
        ops.dense_block, ops.dense_block_bwd = orig
    with no_tf32():
        dx["f32"] = dx_of(lambda a: lax_block(a, [w.float() for w in ws],
                                              bs), x.float(), tgt)
    big = float(dx["f32"].abs().max())

    def rel(a, b):
        return float((dx[a] - dx[b]).abs().max()) / big

    res = dict(ms=ms, launches=launches, max_abs_dx=big,
               tool_dx_maxerr_vs_lax=float(m.group(1)),
               bwd_kernel_vs_plain=float((bwd["kernel"] - bwd["plain"])
                                         .abs().max()) / bwd_big,
               kernel_vs_plain=rel("kernel", "plain"),
               kernel_vs_lax=rel("kernel", "lax"),
               kernel_vs_f32=rel("kernel", "f32"),
               plain_vs_f32=rel("plain", "f32"),
               lax_vs_f32=rel("lax", "f32"))
    print("[grad-bench] " + json.dumps(res), flush=True)
    if not res["bwd_kernel_vs_plain"] <= 2.0 ** -6:
        fail(f"grad_bench: the backward kernels' dx is "
             f"{res['bwd_kernel_vs_plain']} of the largest |dx| from the "
             f"plain backward's on the same buffer and cotangent (bound "
             f"2^-6)")
    bound = (1.0 + GRAD_BENCH_F32_DELTA) * res["lax_vs_f32"]
    print(f"[grad-bench] distance from the float32 dx: kernels "
          f"{res['kernel_vs_f32']:.6f}, plain {res['plain_vs_f32']:.6f}, "
          f"bound (1 + {GRAD_BENCH_F32_DELTA}) x cuDNN's "
          f"{res['lax_vs_f32']:.6f} = {bound:.6f}", flush=True)
    for k in ("kernel_vs_f32", "plain_vs_f32"):
        if not res[k] <= bound:
            fail(f"grad_bench: {k} {res[k]} above (1 + "
                 f"{GRAD_BENCH_F32_DELTA}) x lax_vs_f32 "
                 f"{res['lax_vs_f32']}")
    if calls == 0 or launches["dense_block"] != calls * fwd_launches(5) \
            or launches["dense_block_bwd"] != calls * bwd_launches(
                5, torch.bfloat16):
        fail(f"grad_bench launches {launches} off the formulas")
    return res


def verify_grads_phase():
    """``tools.verify_grads_onchip`` at its defaults (16 x 192², 23
    blocks, the tool's own tolerances): exit 0, the loss delta, the
    worst leaf, one generator forward and one backward of launches."""
    import re

    out = run_tool("verify_grads_onchip", [], 900)
    losses = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(lax|pallas_cf): loss=(\S+) gnorm=", out, re.M)}
    m = re.search(r"^worst leaf reldiff: (\S+) at (\S+); non-finite kernel "
                  r"grad elements: (\d+)$", out, re.M)
    if len(losses) != 2 or not m or "ON-CHIP GRAD PARITY: OK" not in out:
        fail("verify_grads_onchip printed no verdict")
    launches = tool_launches(out)
    res = dict(loss_delta=abs(losses["lax"] - losses["pallas_cf"]),
               losses=losses, worst_leaf_reldiff=float(m.group(1)),
               worst_leaf=m.group(2), nonfinite=int(m.group(3)),
               launches=launches)
    print("[verify-grads] " + json.dumps(res), flush=True)
    if launches["dense_block"] != 345 or launches["dense_block_bwd"] != 552:
        fail(f"verify_grads_onchip launches {launches}: want 345 forward "
             f"and 552 backward (one generator step)")
    return res


TRAIN_BENCH_IMPLS = ("lax", "pallas_cf", "pallas_cf_tail")


def train_bench_phase():
    """``tools.train_bench`` under lax, pallas_cf and pallas_cf_tail, ten
    steps each, GAN and pretrain: ms/step, it/s and the launches of one
    step against the formulas (none of the port's kernels under lax)."""
    import re

    want = {"lax": {},
            "pallas_cf": {"dense_block": 345, "dense_block_bwd": 552},
            "pallas_cf_tail": {"dense_block": 345, "dense_block_bwd": 552,
                               "conv3x3": 4}}
    res = {}
    for step in ("gan", "pretrain"):
        out = run_tool("train_bench", ["--step", step, "--impls",
                                       ",".join(TRAIN_BENCH_IMPLS),
                                       "--steps", "10"], 900)
        res[step] = {"launches": tool_launches(out)}
        for impl in TRAIN_BENCH_IMPLS:
            m = re.search(rf"^{impl}\s+{step}:\s+([\d.]+) it/s  \(([\d.]+) "
                          rf"ms/step, ([\d.]+) MP/s HR.*launches/step "
                          rf"(\{{.*\}})$", out, re.M)
            if not m:
                fail(f"train_bench {step} printed no line for {impl}")
            per_step = json.loads(m.group(4))
            res[step][impl] = dict(it_s=float(m.group(1)),
                                   ms=float(m.group(2)),
                                   hr_mp_s=float(m.group(3)),
                                   launches_per_step=per_step)
            if per_step != want[impl]:
                fail(f"train_bench {step} {impl}: one step launched "
                     f"{per_step}, want {want[impl]}")
    print("[train-bench] " + json.dumps(res), flush=True)
    return res


PROFILE_ROWS = ("preprocess (aug+bicubic+norm)", "G fwd", "G fwd+bwd (L2)",
                "  stem+tail-only fwd+bwd", "  => 23-block trunk fwd+bwd",
                "D fwd (train mode)", "G-step D pass (2 fwd + d/d_sr bwd)",
                "D step (2 fwd + param bwd)", "Adam update (G tree)",
                "Adam update (D tree)")


def profile_gan_phase():
    """``tools.profile_gan --impl pallas_cf --trace``: the component
    table with device times, the full step, the sum, a trace naming the
    dense-block kernels, launches by formula."""
    import re

    with tempfile.TemporaryDirectory() as tmp:
        out = run_tool("profile_gan", ["--impl", "pallas_cf", "--trace",
                                       tmp, "--trace_steps", "2"], 900)
        traces = [n for n in os.listdir(tmp)
                  if n.endswith(".pt.trace.json")]
        if len(traces) != 1:
            fail(f"profile_gan --trace wrote {traces}")
        with open(os.path.join(tmp, traces[0])) as f:
            events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    named = {k: any(k in n for n in names)
             for k in ("conv3x3_wgmma", "bwd_prep", "wgrad_wgmma")}
    table = {}
    for name in PROFILE_ROWS:
        m = re.search(rf"^{re.escape(f'{name:34s}')} +(-?[\d.]+) ms  device "
                      rf"+(-?[\d.]+) ms$", out, re.M)
        if not m:
            fail(f"profile_gan printed no device time for {name.strip()!r}")
        table[name.strip()] = dict(ms=float(m.group(1)),
                                   device_ms=float(m.group(2)))
    m = re.search(r"^FULL GAN step +([\d.]+) ms \(([\d.]+) it/s\)  "
                  r"launches/step (\{.*\})$", out, re.M)
    s = re.search(r"^sum of components +([\d.]+) ms$", out, re.M)
    if not m or not s:
        fail("profile_gan printed no full step or sum")
    res = dict(components=table, full_step_ms=float(m.group(1)),
               sum_of_components_ms=float(s.group(1)),
               full_step_launches=json.loads(m.group(3)),
               trace_names=named, launches=tool_launches(out))
    print("[profile-gan] " + json.dumps(res), flush=True)
    if not all(named.values()):
        fail(f"the trace does not name every dense-block kernel: {named}")
    if res["full_step_launches"] != {"dense_block": 345,
                                     "dense_block_bwd": 552}:
        fail(f"profile_gan: a GAN step launched "
             f"{res['full_step_launches']}")
    return res


TILED_RUNS = (("pallas_cf", ["--decompose"]),
              ("pallas_fused", ["--conv_impl", "pallas_fused"]),
              ("pallas_cf_tail", ["--conv_impl", "pallas_cf_tail"]),
              *((f"tile_{t}", ["--bucket_h", "0", "--tile", str(t)])
                for t in (128, 256, 384, 704)))


def tiled_bench_phase():
    """``tools.tiled_bench`` on the 2048² LR frame: the defaults with
    ``--decompose`` under pallas_cf, then pallas_fused and
    pallas_cf_tail, then the rate against tile height (no bucketing,
    128-wide tiles 128, 256, 384 and 704 high): s/frame, MP/s, the stage
    split, 345 dense-block launches per tile batch (and 4 single convs
    under pallas_cf_tail)."""
    import re

    res = {}
    for name, argv in TILED_RUNS:
        out = run_tool("tiled_bench", argv, 600)
        m = re.search(r"\): ([\d.]+) s/frame = ([\d.]+) MP/s/chip$", out,
                      re.M)
        g = re.search(r"^\[tiled\] tile (\d+)x(\d+), (\d+) tiles, (\d+) tile "
                      r"batches; launches/frame (\{.*\})$", out, re.M)
        if not m or not g:
            fail(f"tiled_bench {name} printed no frame time")
        batches = int(g.group(4))
        per_frame = json.loads(g.group(5))
        run = dict(s_per_frame=float(m.group(1)), mp_s=float(m.group(2)),
                   tile=[int(g.group(1)), int(g.group(2))],
                   tiles=int(g.group(3)), tile_batches=batches,
                   launches_per_frame=per_frame,
                   launches=tool_launches(out))
        if name == "pallas_cf":
            run["stages_s"] = {
                k: float(v) for k, v in re.findall(
                    r"^\[tiled\] stage (\w+)\s*: ([\d.]+) s$", out, re.M)}
            if len(run["stages_s"]) != 3:
                fail(f"tiled_bench --decompose: {run['stages_s']}")
        block = "dense_block_nhwc" if name == "pallas_fused" \
            else "dense_block"
        want = {block: 345 * batches}
        if name == "pallas_cf_tail":
            want["conv3x3"] = 4 * batches
        if per_frame != want:
            fail(f"tiled_bench {name}: a frame launched {per_frame}, want "
                 f"{want}")
        res[name] = run
    print("[tiled-bench] " + json.dumps(res), flush=True)
    return res


def halo_parity_phase(ck, work, serve_sd):
    """``tools.halo_parity`` on the train phase's step directory
    (``--weights auto``, float32 and bfloat16) and on the serve phase's
    seeded ``.pth``: one line per halo, launches by formula."""
    import re

    import torch

    pth = os.path.join(work, "serve_weights.pth")
    torch.save(serve_sd, pth)
    res = {}
    for name, argv in (("ck_float32", ["--checkpoint", ck]),
                       ("ck_bfloat16", ["--checkpoint", ck, "--dtype",
                                        "bfloat16"]),
                       ("pth_float32", ["--checkpoint", pth])):
        out = run_tool("halo_parity", argv, 600)
        rows = {int(h): dict(max=float(a), mean=float(b),
                             psnr_vs_whole_db=float(p))
                for h, a, b, p in re.findall(
                    r"^\[halo\] halo=\s*(\d+) \(waste .*\): max=(\S+) "
                    r"mean=(\S+) uint8_lsb_max=\d+ psnr_vs_whole=(\S+)dB$",
                    out, re.M)}
        launches = tool_launches(out)
        res[name] = dict(rows=rows, launches=launches)
        if sorted(rows) != [2, 4, 6, 8, 12]:
            fail(f"halo_parity {name}: rows for halos {sorted(rows)}")
        if not launches["dense_block"] or launches["dense_block"] % 345:
            fail(f"halo_parity {name}: launches {launches}")
    print("[halo-parity] " + json.dumps(res), flush=True)
    return res


def demo_phase():
    """``tools.demo_train_eval --steps 200 --gan_steps 50 --blocks 23
    --conv_impl pallas_cf``: it completes, every number it prints is
    finite; whether the PSNR model beats bicubic and whether the GAN
    sharpens are recorded, not gated."""
    import re

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = run_tool("demo_train_eval", [
            "--steps", "200", "--gan_steps", "50", "--blocks", "23",
            "--conv_impl", "pallas_cf", "--out", os.path.join(tmp, "demo")],
            1200)
        secs = time.perf_counter() - t0
    rows = {m.group(1): {k: float(v) for k, v in re.findall(
                r"(\w+)=(\S+)", m.group(2))}
            for m in re.finditer(r"^\[demo\] (bicubic|psnr|gan|gan_ema)\s*: "
                                 r"(.*)$", out, re.M)}
    gain = re.search(r"PSNR-model gain over bicubic: (\S+) dB \((.*)\)", out)
    sharp = re.search(r"GAN sharpness gain over PSNR model: (\S+) .*; "
                      r"(\w+ ?\w*)\)", out)
    numbers = []         # every key=value number, and the two gains
    for v in re.findall(r"=(\S+)|gain over \S+(?: model)?: (\S+)", out):
        try:
            numbers.append(float((v[0] or v[1]).rstrip(")],;")))
        except ValueError:
            pass
    launches = tool_launches(out)
    res = dict(s=secs, rows=rows, psnr_gain_db=float(gain.group(1))
               if gain else None, psnr_verdict=gain.group(2) if gain else None,
               gan_sharpness_gain=float(sharp.group(1)) if sharp else None,
               gan_verdict=sharp.group(2) if sharp else None,
               launches=launches)
    print("[demo] " + json.dumps(res), flush=True)
    if sorted(rows) != ["bicubic", "gan", "gan_ema", "psnr"] or not gain \
            or not sharp:
        fail(f"demo_train_eval printed no comparison: {sorted(rows)}")
    if not all(math.isfinite(v) for v in numbers):
        fail("demo_train_eval printed a number that is not finite")
    if launches["dense_block_bwd"] != 250 * 552 \
            or launches["dense_block"] % 345:
        fail(f"demo_train_eval launches {launches}: want 552 backward "
             f"launches per step of 250")
    return res


def logged(card, path, kernel):
    """``kernel``'s launches on ``path`` as the card tests counted them
    (:func:`card_tests`)."""
    if path not in card:
        fail(f"the card tests logged no launches of the path {path}")
    return card[path].get(kernel, 0)


def tools_path_launches(runs):
    """Launches by counter summed over the new tools' runs."""
    total = {}
    for launches in runs:
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "super_resolution_tpu_torch")):
        print("chip_smoke: the super_resolution_tpu_torch package is not "
              f"beside {__file__}; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this smoke test runs "
              "only on the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from super_resolution_tpu_torch.bench import card_line

    smi = card_line()
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
    card = card_tests()

    kern = kernel_times()
    kern_bwd = bwd_times()
    conv = conv3x3_times()
    fused = fused_times()
    experiments = experiments_times()
    int8 = int8_times()
    swin = swinir_times()
    aln = add_layernorm_times()
    serve, sd_serve = serve_phase()
    with tempfile.TemporaryDirectory() as work:
        ck = os.path.join(work, "ck")
        train = train_phase(ck)
        t_new = time.perf_counter()
        evals = eval_phase(sd_serve, work, smi)
        export_phase(ck, work, sd_serve, smi)
        print(f"[eval+export] the two phases took "
              f"{time.perf_counter() - t_new:.1f} s", flush=True)
        t_new = time.perf_counter()
        halo = halo_parity_phase(ck, work, sd_serve)
        t_halo = time.perf_counter() - t_new
    tools = tools_phase()
    t_new = time.perf_counter()
    train_dp = train_dp_phase()
    profile_dir_phase()
    build_cache_phase()
    print(f"[train-dp+profile-dir+build-cache] the three phases took "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    t_new = time.perf_counter()
    grain_phase()
    convert_vgg_phase()
    grad = grad_bench_phase()
    vgrads = verify_grads_phase()
    tbench = train_bench_phase()
    prof = profile_gan_phase()
    tiled = tiled_bench_phase()
    demo = demo_phase()
    print(f"[grain+convert-vgg+grad-bench+verify-grads+train-bench+"
          f"profile-gan+tiled-bench+demo] the eight phases took "
          f"{time.perf_counter() - t_new:.1f} s, [halo-parity] "
          f"{t_halo:.1f} s", flush=True)
    # the tools' runs, each counted from 0 in its own process
    tools_path = tools_path_launches([
        grad["launches"], vgrads["launches"],
        tbench["gan"]["launches"], tbench["pretrain"]["launches"],
        prof["launches"], *(r["launches"] for r in tiled.values()),
        *(r["launches"] for r in halo.values()), demo["launches"]])

    flag = kern["flagship"]
    serve_launches = serve["upscale_launches"] + serve["serve_launches"]
    # the data-parallel path: cli train with one NCCL rank, then the two
    # gloo ranks' steps, each counted from 0
    dp_runs = [train_dp["a"]["launches"],
               *train_dp["b"]["launches_per_rank"]]
    dp_fwd = sum(r.get("dense_block", 0) for r in dp_runs)
    dp_bwd = sum(r.get("dense_block_bwd", 0) for r in dp_runs)
    # the paths that the card tests drive, each counted in its test: the
    # bench's own workload, eval_batch (bf16 and fp32), cli upscale
    # under pallas_cf_tail, pallas and pallas_fused, cli train under
    # pallas_cf_tail, one polyphase forward under each tail impl
    bench_path = logged(card, "bench", "dense_block")
    eval_batch_path = sum(logged(card, f"eval_batch_{d}", "dense_block")
                          for d in ("bfloat16", "float32"))
    up_conv = {impl: logged(card, f"upscale_{impl}", "conv3x3")
               for impl in ("pallas_cf_tail", "pallas")}
    train_tail = logged(card, "train_pallas_cf_tail", "conv3x3")
    poly_conv = {impl: logged(card, f"polyphase_{impl}", "conv3x3")
                 for impl in ("pallas_cf_tail", "pallas")}
    up_nhwc = logged(card, "upscale_pallas_fused", "dense_block_nhwc")

    def times(row, **over):
        """A kernel's times from its timing row, ``over`` replacing
        fields of it."""
        row = dict(row, **over)
        return {"ms": row["kernel_ms"], **{k: row[k] for k in (
            "plain_ms", "bound_ms", "bound_by", "library_ms")}}

    print(json.dumps({"kernels": [{
        "name": "dense_block",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/dense_block.cu",
        "replaces": REPLACES,
        # the user's entry points, each counted from 0: cli upscale and
        # cli serve --once, then cli train, then cli eval, the bench and
        # eval_batch
        "launches": serve_launches + train["fwd_launches"]
        + evals["launches"] + dp_fwd + tools_path["dense_block"]
        + bench_path + eval_batch_path,
        "launches_serve_path": serve_launches,
        "launches_bench_path": bench_path,
        "launches_eval_batch_path": eval_batch_path,
        "launches_train_path": train["fwd_launches"],
        "launches_eval_path": evals["launches"],
        "launches_train_dp_path": dp_fwd,
        "launches_tools_path": tools_path["dense_block"],
        **times(flag),
        "train_shape_ms": kern["train"]["kernel_ms"],
    }, {
        "name": "dense_block_bwd",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/dense_block_bwd.cu",
        "replaces": REPLACES_BWD,
        # cli train, then the data-parallel path, then the tools
        "launches": train["bwd_launches"] + dp_bwd
        + tools_path["dense_block_bwd"],
        "launches_train_dp_path": dp_bwd,
        "launches_tools_path": tools_path["dense_block_bwd"],
        "launches_per_block": kern_bwd["launches"],
        **times(kern_bwd),
        "kernels_device_ms": kern_bwd["kernels_device_ms"],
    }, {
        "name": "conv3x3",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/conv3x3.cu",
        "replaces": REPLACES_CONV,
        # cli upscale --conv_impl pallas_cf_tail and pallas, cli train
        # --conv_impl pallas_cf_tail, one polyphase forward under each of
        # the two impls, then the tools' runs under pallas_cf_tail
        # (tiled_bench, train_bench)
        "launches": sum(up_conv.values()) + train_tail
        + sum(poly_conv.values()) + tools_path["conv3x3"],
        "launches_tools_path": tools_path["conv3x3"],
        "launches_polyphase_forward": poly_conv,
        "launches_upscale_pallas_cf_tail": up_conv["pallas_cf_tail"],
        "launches_upscale_pallas": up_conv["pallas"],
        "launches_train_pallas_cf_tail": train_tail,
        # the flagship tail's 512 x 512 plane (hr_conv, upconv2)
        **times(conv["hr_conv_512"]),
        "ms_by_shape": {k: v["kernel_ms"] for k, v in conv.items()},
    }, {
        "name": "dense_block_nhwc",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/dense_block.cu",
        "replaces": REPLACES_NHWC,
        # cli upscale --conv_impl pallas_fused, then tiled_bench's runs
        # under pallas_fused
        "launches": up_nhwc + tools_path["dense_block_nhwc"],
        "launches_upscale_pallas_fused": up_nhwc,
        "launches_tools_path": tools_path["dense_block_nhwc"],
        **times(fused),
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
        **times(experiments["cf3_flagship"]),
        "ms_by_case": {k: v["kernel_ms"] for k, v in experiments.items()},
    }, {
        "name": "dense_block_int8",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/dense_block_int8.cu",
        "replaces": REPLACES_INT8,
        # tools.kernel_bench v8, counted from 0
        "launches": tools["kernel_bench_launches"]["fused_dense_block_cf8"],
        # no PyTorch call computes this function (library_ms None);
        # cuDNN's bf16 block for scale
        **times(int8["flagship_rows16"]),
        "cudnn_bf16_block_ms": int8["flagship_rows16"]["cudnn_block_ms"],
        # n + 2 launches a call, counted
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
    }, {
        "name": "window_attention",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/window_attention.cu",
        # the JAX package computes no attention
        "replaces": None,
        # SwinIR-L's forwards through make_infer_fn (the path of cli
        # upscale --preset swinir_l_real_x4), counted from 0
        "launches": swin["launches_forward"],
        # (1, 1024, 1024, 720) bf16 qkv, the mean of shift 0 and 4; the
        # library: roll, partition, one scaled_dot_product_attention
        # with the bias and mask as its additive mask, reverse, roll back
        **times(swin, kernel_ms=swin["ms"], bound_ms=swin["bound_ms_1024"],
                bound_by="bytes"),
    }, {
        "name": "add_layernorm",
        "route": "cuda",
        "source": "super_resolution_tpu_torch/csrc/add_layernorm.cu",
        # the JAX package has no LayerNorm
        "replaces": None,
        # SwinIR-L's forwards of the swinir timing: 110 a forward
        "launches": swin["add_layernorm_launches_forward"],
        # (1, 1024, 1024, 240) bf16 with a branch (108 of SwinIR-L's
        # 110 calls); both cases, "add" and "norm", under *_by_kind; the
        # library: x + b, then F.layer_norm
        **times({k: v["add"] for k, v in aln.items()}, bound_by="bytes"),
        "ms_by_kind": aln["kernel_ms"],
        "plain_ms_by_kind": aln["plain_ms"],
        "bound_ms_by_kind": aln["bound_ms"],
        "library_ms_by_kind": aln["library_ms"],
    }]}))
    print(f"[time] chip_smoke took {time.perf_counter() - t_start:.1f} s "
          f"from the card check to the result", file=sys.stderr, flush=True)
    print(smi)                       # card name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
