"""The port's benches (``tools.grad_bench``, ``train_bench``,
``profile_gan``, ``tiled_bench``) driven through ``main(argv)`` on
``--device cpu`` at tiny sizes: each prints the JAX tool's line formats,
no ``FAILED``, and a ``launches:`` line; every flag that tunes a TPU
mechanism is refused with "not ported"; ``tiled_bench``'s timed frame is
``tiled_upscale``'s, and its ``--decompose`` stages blend to that frame,
bit for bit; and every new tool asked for ``--device cuda`` on a machine
without a card raises instead of running on the CPU.

The CPU runs the kernels' plain versions: these tests hold the tools'
control flow and formats; their times and launch counts come from the
card (``chip_smoke.py``).  Sizes: the canonical generator cut to one
RRDB (the tools have no depth flag: the tests swap ``config``'s
``GeneratorConfig`` for one whose default depth is 1) at batch 1-2 of
8 x 8 LR; the dense block at (1, 64, 8, 8); one torch thread per test.
"""

import argparse
import dataclasses
import json
import re

import pytest
import torch

from super_resolution_tpu_torch import config
from super_resolution_tpu_torch.parallel.tiling import tiled_upscale
from super_resolution_tpu_torch.tools import (
    demo_train_eval,
    grad_bench,
    halo_parity,
    profile_gan,
    tiled_bench,
    train_bench,
    verify_grads_onchip,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs six workers on one
    host, and spinning thread pools would slow the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass(frozen=True)
class OneBlock(config.GeneratorConfig):
    """The canonical generator cut to one RRDB (the tools build their
    GeneratorConfig from ``config``; they have no depth flag)."""

    n_blocks: int = 1


@pytest.fixture
def one_block(monkeypatch):
    monkeypatch.setattr(config, "GeneratorConfig", OneBlock)


CPU = ["--device", "cpu"]


def _run(tool, argv, capsys):
    assert tool.main(argv) == 0
    out = capsys.readouterr().out
    assert "FAILED" not in out
    launches = json.loads(out.rstrip().splitlines()[-1]
                          .split("launches: ", 1)[1])
    assert set(launches) >= {"dense_block", "dense_block_bwd", "conv3x3"}
    return out


def test_grad_bench_lines(capsys):
    out = _run(grad_bench, [*CPU, "--batch", "1", "--h", "8", "--w", "8"],
               capsys)
    assert re.search(r"^lax         :\s+[\d.]+ ms\s+[\d.]+ TF/s \(fwd\+bwd\)$",
                     out, re.M)
    m = re.search(r"^kernel      :\s+[\d.]+ ms\s+[\d.]+ TF/s \(fwd\+bwd\)  "
                  r"dx maxerr vs lax (\S+) of max \|dx\| (\S+)$", out, re.M)
    # the two bf16 paths round in other places: the difference is
    # recorded, not bounded (chip_smoke holds the kernels against their
    # plain version)
    assert m and 0 < float(m.group(1)) < float(m.group(2))
    assert re.search(r"^kernel_fold : .*not ported", out, re.M)


def test_train_bench_lines(one_block, capsys):
    out = _run(train_bench, [*CPU, "--batch", "2", "--hr", "32", "--steps",
                             "1", "--impls", "pallas_cf,pallas"], capsys)
    assert re.search(r"^pallas_cf  compile\+first: \d+s$", out, re.M)
    for impl in ("pallas_cf", "pallas"):
        assert re.search(rf"^{impl:10s} gan:\s+[\d.]+ it/s  \([\d.]+ ms/step, "
                         rf"[\d.]+ MP/s HR, batch 2x32²\)  launches/step "
                         rf"\{{.*\}}$", out, re.M), impl
    # pallas has no backward: it trains on lax and says so, as the CLI
    assert "conv_impl='pallas' has no backward: training on 'lax'" in out


def test_profile_gan_lines(one_block, capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(profile_gan, "ITERS", 1)
    monkeypatch.setattr(profile_gan, "FULL_STEPS", 1)
    monkeypatch.setattr(profile_gan, "SPAN_CALLS", 100)
    out = _run(profile_gan, [*CPU, "--batch", "2", "--hr", "32", "--impl",
                             "pallas_cf", "--trace", str(tmp_path / "tr"),
                             "--trace_steps", "1"], capsys)
    for name in ("preprocess (aug+bicubic+norm)", "G fwd", "G fwd+bwd (L2)",
                 "  stem+tail-only fwd+bwd", "  => 23-block trunk fwd+bwd",
                 "D fwd (train mode)", "G-step D pass (2 fwd + d/d_sr bwd)",
                 "D step (2 fwd + param bwd)", "Adam update (G tree)",
                 "Adam update (D tree)"):
        # no device time is claimed on the CPU
        assert re.search(rf"^{re.escape(f'{name:34s}')} +-?[\d.]+ ms  "
                         rf"device not measured$", out, re.M), name
    assert re.search(r"^FULL GAN step +[\d.]+ ms \([\d.]+ it/s\)  "
                     r"launches/step \{.*\}$", out, re.M)
    assert re.search(r"^sum of components +[\d.]+ ms$", out, re.M)
    assert len(list((tmp_path / "tr").glob("*.pt.trace.json"))) == 1
    assert len(list((tmp_path / "tr").glob("*.spans.json"))) == 1
    # the phase table from the spans, recording on against off
    assert re.search(r"^FULL GAN step, spans recording +[\d.]+ ms \(off "
                     r"[\d.]+ ms, on-cost [-+][\d.]+ ms", out, re.M)
    for name in ("train.gan_step", "train.g_forward", "train.adam_g"):
        assert re.search(rf"^  {re.escape(name)} +1\.0 calls +[\d.]+ ms "
                         rf"+[\d.]+ %$", out, re.M), name
    assert re.search(r"^span cost per call: off [\d.]+ us  on [\d.]+ us  "
                     r"profiler [\d.]+ us$", out, re.M)


TILED = argparse.Namespace(tile=40, halo=2, tile_batch=2, tile_w=16,
                           bucket_h=8)


@pytest.fixture(scope="module")
def tiled_frame():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "GeneratorConfig", OneBlock)
        infer = tiled_bench.make_infer("pallas_cf", torch.device("cpu"))
    lr = tiled_bench.make_frame(40, 40, torch.device("cpu"))
    return infer, lr, tiled_bench.run_frame(infer, lr, TILED)


def test_tiled_bench_frame_is_tiled_upscale(tiled_frame):
    infer, lr, frame = tiled_frame
    direct = tiled_upscale(infer, lr, scale=4, tile=40, halo=2,
                           tile_batch=2, tile_w=16, bucket_h=8)
    assert frame.shape == (160, 160, 3)
    assert torch.equal(frame, direct)


def test_tiled_bench_decompose_blends_the_frame(tiled_frame):
    infer, lr, frame = tiled_frame
    extract, infer_all, blend = tiled_bench.stages(infer, lr, TILED)
    tiles, _ = extract()
    assert tiles.shape == (3, 40, 16, 3)
    assert [b.shape[0] for b in infer_all()] == [2, 1]
    assert torch.equal(blend(), frame)


def test_tiled_bench_lines(one_block, capsys):
    out = _run(tiled_bench, [*CPU, "--frame", "40", "--tile_w", "16",
                             "--halo", "2", "--bucket_h", "8", "--reps", "1",
                             "--decompose"], capsys)
    for stage in ("extract ", "infer   ", "blend   "):
        assert re.search(rf"^\[tiled\] stage {stage}: [\d.]+ s$", out, re.M)
    assert re.search(r"^\[tiled\] 40x40 LR -> 160x160 SR \(pallas_cf, "
                     r"tile=40x16 halo=2 batch=2 bucket_h=8\): [\d.]+ "
                     r"s/frame = [\d.]+ MP/s/chip$", out, re.M)
    assert re.search(r"^\[tiled\] tile 40x16, 3 tiles, 2 tile batches; "
                     r"launches/frame \{.*\}$", out, re.M)


@pytest.mark.parametrize("tool,flags", [
    (grad_bench, ["--rows", "8"]),
    (grad_bench, ["--bwd_cap", "4608"]),
    (grad_bench, ["--bwd_carry"]),
    (grad_bench, ["--no-bwd_carry"]),
    (train_bench, ["--cf9"]),
    (train_bench, ["--bwd_cap", "4608"]),
    (train_bench, ["--fwd_carry"]),
    (train_bench, ["--bwd_carry"]),
    (profile_gan, ["--cf9"]),
    (profile_gan, ["--bwd_cap", "1"]),
    (profile_gan, ["--fwd_carry"]),
    (profile_gan, ["--no-bwd_carry"]),
    (tiled_bench, ["--fwd_cap", "5120"]),
    (tiled_bench, ["--no-cf9"]),
    (tiled_bench, ["--fwd_carry"]),
    (verify_grads_onchip, ["--cf9"]),
    (verify_grads_onchip, ["--bwd_cap", "4608"]),
    (verify_grads_onchip, ["--fwd_carry"]),
    (verify_grads_onchip, ["--bwd_carry"]),
], ids=lambda v: v.__name__.rsplit(".", 1)[-1] if hasattr(v, "__name__")
    else " ".join(v))
def test_tpu_flags_are_refused(tool, flags):
    with pytest.raises(SystemExit, match="not ported"):
        tool.main([*CPU, *flags])


@pytest.mark.parametrize("tool,argv", [
    (grad_bench, []), (train_bench, []), (profile_gan, []),
    (tiled_bench, []), (verify_grads_onchip, []),
    (halo_parity, ["--checkpoint", "absent.pth"]),
    (demo_train_eval, ["--out", "absent_dir"]),
], ids=lambda v: v.__name__.rsplit(".", 1)[-1] if hasattr(v, "__name__")
    else "")
def test_cuda_without_a_card_raises(tool, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([*argv, "--device", "cuda"])
    assert not list(tmp_path.iterdir())
