"""The bounds and helpers that the port's checks on the card share, each
defined once: ``tests/test_torch_cuda.py`` (every check made on the
card, with the bounds only it uses), ``chip_smoke.py`` (its CLI, tool
and multi-process phases) and ``tests/test_torch_surface.py`` (which
holds some of them on the CPU) import them.  Nothing here imports JAX:
the card's machine has none.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import time

import numpy as np
import torch

# kernel vs plain, elementwise |k - p| <= atol + rtol*|p|.  bf16: about
# two bf16 ULPs — each conv output is rounded to bf16, and an f32 sum in
# another order can flip a rounding by one ULP that later convs of the
# block carry.  fp32: the same arithmetic in another summation order.
TOL = {torch.bfloat16: (2.0 ** -6, 2.0 ** -6), torch.float32: (2e-5, 1e-5)}
# a generator forward through the kernels vs the same forward through
# the plain kernels: bf16 PSNR over the plain output's range (rounding
# flips spread by the blocks), fp32 (atol, rtol) elementwise
BF16_MODEL_PSNR_FLOOR_DB = 40.0
FP32_MODEL_TOL = (1e-4, 1e-4)
# an eval through the kernel against the same eval through the plain
# dense block, bf16, 23 blocks: rounding flips move the SR image by a
# few hundredths of an LSB on average, which moves a PSNR of order
# 10-30 dB by far less than this; a fault at a tile or a channel moves
# whole regions.  fp32 with TF32 off: the summation order only.
EVAL_PLAIN_PSNR_DB = 0.05
EVAL_BATCH_PLAIN_DB = {torch.bfloat16: EVAL_PLAIN_PSNR_DB,
                       torch.float32: 1e-3}
# the whole forward + backward's dx of the kernels and of the plain
# block, each at a distance from the float32 dx of at most (1 + delta)
# times cuDNN's bf16 autograd's.  delta was fixed before the first run
# that applied it.  bf16 rounding carried through the forward puts all
# three near 0.029 of the largest |dx| (kernels over cuDNN 0.9989 on an
# NVIDIA H100 80GB HBM3, 700 W); a wrong tap or a dropped slice moves dx
# by a large fraction of its size, far past that.
GRAD_BENCH_F32_DELTA = 0.25


def sr_vs_plain(sr, ref, dtype, fp32_tol=FP32_MODEL_TOL):
    """A forward's agreement with its plain version: bf16 the PSNR over
    the plain output's range (ok at or above
    ``BF16_MODEL_PSNR_FLOOR_DB``), fp32 the worst |k - p| - rtol·|p| -
    atol under ``fp32_tol`` (ok at or below 0): (value, ok)."""
    sr, ref = sr.float(), ref.float()
    if dtype == torch.bfloat16:
        mse = ((sr - ref) ** 2).mean().item()
        span = (ref.max() - ref.min()).item()
        db = 10 * math.log10(span ** 2 / mse) if mse > 0 else float("inf")
        return db, db >= BF16_MODEL_PSNR_FLOOR_DB
    atol, rtol = fp32_tol
    worst = ((sr - ref).abs() - rtol * ref.abs()).max().item() - atol
    return worst, worst <= 0


class PlainKernels:
    """Every kernel wrapper the model calls replaced by its plain version
    while the block runs."""

    def __enter__(self):
        from super_resolution_tpu_torch.models import rrdb

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


def drop_centre_tap(weights):
    """Packed dense-block weights with conv 2's centre tap (tap 4 of
    (9, cout, cin)) zeroed: a fault of the kind the checks must catch."""
    weights = list(weights)
    weights[1] = weights[1].clone()
    weights[1][4] = 0
    return weights


class CheckedDenseBlock:
    """``models.rrdb``'s dense block replaced by the kernel, each call's
    output held against ``dense_block_plain`` on the same input and
    weights: ``excess`` is the worst |k - p| - rtol·|p| - atol under
    ``TOL[dtype]`` over the calls (> 0 fails).  ``fault`` changes the
    weights the kernel is given; the plain version gets them as they
    are."""

    def __init__(self, dtype, fault=None):
        self.tol, self.fault, self.excess = TOL[dtype], fault, []

    def __enter__(self):
        from super_resolution_tpu_torch.models import rrdb
        from super_resolution_tpu_torch.ops.dense_block import (
            dense_block_plain,
        )

        self.rrdb, kernel = rrdb, rrdb.dense_block
        atol, rtol = self.tol

        def checked(x, weights, biases, **kw):
            y = kernel(x, self.fault(weights) if self.fault else weights,
                       biases, **kw)
            p = dense_block_plain(x, weights, biases, **kw).float()
            self.excess.append(((y.float() - p).abs() - rtol * p.abs())
                               .max() - atol)
            return y

        rrdb.dense_block, self.kernel = checked, kernel
        return self

    def __exit__(self, *exc):
        self.rrdb.dense_block = self.kernel

    def worst(self) -> float:
        return float(torch.stack(self.excess).max())


def eval_batch_sr(cfg, sd, hr, device="cuda"):
    """``train.steps.eval_batch`` on ``device``: (its PSNR, the SR batch
    its forward made)."""
    import super_resolution_tpu_torch.train.steps as steps

    make, sr = steps.make_infer_fn, []

    def recording(*args, **kw):
        infer = make(*args, **kw)

        def run(lr):
            sr.append(infer(lr))
            return sr[-1]

        return run

    steps.make_infer_fn = recording
    try:
        psnr = float(steps.eval_batch(cfg, sd, hr, device)["psnr"])
    finally:
        steps.make_infer_fn = make
    return psnr, sr[0]


def eval_batch_checks(cfg, sd, hr, device, fault=False):
    """``eval_batch`` through the plain kernels, then through the kernel
    with each dense-block call held to its plain version
    (:class:`CheckedDenseBlock`; with ``fault``, conv 2's centre tap
    dropped from the kernel's weights), TF32 off: (plain PSNR, plain SR
    batch, PSNR, SR batch, the :class:`CheckedDenseBlock`)."""
    from super_resolution_tpu_torch.device import no_tf32

    dtype = getattr(torch, cfg.compute_dtype)
    with no_tf32():
        with PlainKernels():
            plain, sr_plain = eval_batch_sr(cfg, sd, hr, device)
        with CheckedDenseBlock(dtype, drop_centre_tap if fault
                               else None) as block:
            psnr, sr = eval_batch_sr(cfg, sd, hr, device)
    return plain, sr_plain, psnr, sr, block


# the environment variable naming a file that the card tests append the
# launches of the main paths they drive to, one JSON line a run
LAUNCH_LOG_ENV = "CARD_LAUNCH_LOG"


def log_launches(path, launches):
    """Append ``launches`` (kernel -> count), counted in one run of the
    path named ``path``, to the file that ``$CARD_LAUNCH_LOG`` names, if
    it names one."""
    log = os.environ.get(LAUNCH_LOG_ENV)
    if log:
        with open(log, "a") as f:
            f.write(json.dumps({"path": path, "launches": launches}) + "\n")


def read_launch_log(log):
    """The launches in a file written by :func:`log_launches`: path ->
    kernel -> count, summed over the path's runs."""
    out = {}
    if not os.path.exists(log):
        return out
    with open(log) as f:
        for line in f:
            rec = json.loads(line)
            mine = out.setdefault(rec["path"], {})
            for k, v in rec["launches"].items():
                mine[k] = mine.get(k, 0) + v
    return out


def seeded_block(shape, growth, dtype, device, seed=0, n=5,
                 layout="packed"):
    """One dense block drawn from ``seed`` on ``device``: (x, the n
    convs' weights, their float32 biases).  Weights are drawn OIHW,
    scaled by sqrt(2 / (9 cin)), and returned in ``layout``: "packed"
    (9, cout, cin), "oihw", or "hwio" (the experiment kernels')."""
    pack = importlib.import_module(
        "super_resolution_tpu_torch.ops.dense_block").pack_weight
    relayout = {"packed": pack, "oihw": lambda w: w,
                "hwio": lambda w: w.permute(2, 3, 1, 0).contiguous()}[layout]
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=gen).to(device, dtype)
    ws, bs, cin = [], [], c
    for k in range(n):
        cout = c if k == n - 1 else growth
        wk = torch.randn(cout, cin, 3, 3, generator=gen) \
            * math.sqrt(2.0 / (9 * cin))
        ws.append(relayout(wk).to(device, dtype))
        bs.append((torch.randn(cout, generator=gen) * 0.1).to(device))
        cin += growth
    return x, ws, bs


def launch_counters():
    """Kernel name -> the wrapper that counts its launches."""
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


def rgba_frame(h, w, rng):
    """A synthetic RGBA uint8 frame: gradients with noise from ``rng``
    and a smooth alpha plane."""
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([(xx * 255 // w), (yy * 255 // h),
                    ((xx + yy) * 255 // (h + w))], -1).astype(np.int16)
    rgb = np.clip(rgb + rng.integers(-20, 21, rgb.shape), 0, 255)
    alpha = (128 + 127 * np.sin(xx / 17.0) * np.cos(yy / 23.0))
    return np.concatenate([rgb, alpha[..., None]], -1).astype(np.uint8)
