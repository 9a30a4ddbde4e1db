"""The port's spans and counters (``metrics.span``, ``count``,
``recording``, ``span_report``) on the CPU: nothing recorded while
recording is off, parents and self time, threads, the profiler's own
timeline and a fresh report per profiler session, the GAN and pretrain
steps' phases, the tiling's counters, ``spans.json`` beside the
``--profile_dir`` trace, and the synchronised throughput meter."""

import glob
import importlib
import json
import os
import threading
import time

import pytest
import torch

from super_resolution_tpu_torch import metrics
from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.config import (
    DataConfig,
    DiscriminatorConfig,
    GeneratorConfig,
    TrainConfig,
    VGGConfig,
)
from super_resolution_tpu_torch.metrics import (
    Throughput,
    count,
    recording,
    span,
    span_report,
)
from super_resolution_tpu_torch.parallel import tiling
from super_resolution_tpu_torch.train.state import init_state
from super_resolution_tpu_torch.train.steps import (
    make_gan_step,
    make_pretrain_step,
)

# the module (the package's ``ops`` exports the function by its name)
db = importlib.import_module("super_resolution_tpu_torch.ops.dense_block")
GAN_PHASES = ("train.prep", "train.g_forward", "train.d_real",
              "train.g_loss", "train.vgg", "train.g_backward",
              "train.d_grads", "train.grad_allreduce", "train.adam_g",
              "train.adam_d", "train.ema", "train.step_metrics")
PRETRAIN_PHASES = ("train.prep", "train.g_forward", "train.g_loss",
                   "train.g_backward", "train.grad_allreduce",
                   "train.adam_g", "train.ema", "train.step_metrics")


def test_nothing_is_recorded_while_recording_is_off():
    with recording():
        pass                        # a fresh, empty report
    assert not metrics._ON
    with span("off.span"):
        count("off.count", 3)
    report = span_report()
    assert report["spans"] == {}
    assert "off.count" not in report["counters"]
    # one shared no-op context
    assert span("a") is span("b", torch.device("cpu"))


def test_nested_spans_give_calls_host_and_self_time():
    with recording():
        with span("outer"):
            time.sleep(0.01)
            with span("inner"):
                time.sleep(0.02)
            with span("inner", torch.device("cpu")):
                time.sleep(0.01)
        count("things", 2)
        count("things")
    report = span_report()
    outer, inner = report["spans"]["outer"], report["spans"]["inner"]
    assert outer["calls"] == 1 and inner["calls"] == 2
    assert inner["host_s"] >= 0.03 and outer["host_s"] >= 0.04
    assert inner["self_host_s"] == inner["host_s"]
    assert outer["self_host_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert 0.01 <= outer["self_host_s"] < outer["host_s"]
    # host spans, and spans on the CPU, have no device time
    assert "device_s" not in outer and "device_s" not in inner
    assert report["counters"]["things"] == 3


def test_a_span_on_another_thread_is_not_a_child():
    def work():
        with span("worker"):
            time.sleep(0.02)

    with recording():
        with span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    spans = span_report()["spans"]
    assert spans["worker"]["calls"] == 1 and spans["worker"]["host_s"] >= 0.02
    assert spans["main"]["self_host_s"] == spans["main"]["host_s"]
    assert spans["main"]["host_s"] >= spans["worker"]["host_s"]


def test_spans_on_the_profiler_timeline_and_a_fresh_report_per_session():
    with torch.profiler.profile() as prof:
        assert metrics._ON
        with span("p.outer"):
            with span("p.inner"):
                torch.ones(8).sum()
        count("p.count")
    assert not metrics._ON
    events = {e.name: e for e in prof.events()}
    outer, inner = events["p.outer"], events["p.inner"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    report = span_report()
    assert report["spans"]["p.outer"]["calls"] == 1
    assert report["counters"]["p.count"] == 1

    with torch.profiler.profile() as prof:
        with span("p.second"):
            pass
    assert "p.second" in {e.name for e in prof.events()}
    report = span_report()
    assert set(report["spans"]) == {"p.second"}
    assert "p.count" not in report["counters"]


def test_the_report_reads_the_launch_counters_in(monkeypatch):
    monkeypatch.setattr(db.dense_block, "launches", 7)
    with recording():
        db.dense_block.launches += 5
    counters = span_report()["counters"]
    assert counters["launches.dense_block"] == 5
    assert counters["launches.dense_block_bwd"] == 0
    assert {"launches.fused_dense_block", "launches.conv3x3"} <= set(counters)


def _tiny_cfg(**top):
    return TrainConfig(
        generator=GeneratorConfig(filters=16, growth=8, n_blocks=1,
                                  init="torch_default"),
        discriminator=DiscriminatorConfig(base_filters=8, n_scales=2),
        vgg=VGGConfig(arch=(8, 8, "M", 16, 16)),
        data=DataConfig(hr_patch=32, batch_size=2),
        compute_dtype="float32", **top)


@pytest.mark.parametrize("dedup", [False, True])
def test_gan_step_records_each_phase_once_per_step(dedup):
    cfg = _tiny_cfg(dedup_d_hr=dedup)
    state = init_state(cfg, "cpu")
    step = make_gan_step(cfg)
    hr = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0))
    with recording():
        for _ in range(2):
            step(state, hr)
    spans = span_report()["spans"]
    assert set(spans) == {"train.gan_step", *GAN_PHASES}
    assert all(s["calls"] == 2 for s in spans.values()), spans
    children = sum(spans[n]["host_s"] for n in GAN_PHASES
                   if n != "train.vgg")
    assert children <= spans["train.gan_step"]["host_s"]
    assert spans["train.vgg"]["host_s"] <= spans["train.g_loss"]["host_s"]


def test_pretrain_step_records_its_phases():
    cfg = _tiny_cfg()
    state = init_state(cfg, "cpu")
    hr = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    with recording():
        make_pretrain_step(cfg)(state, hr)
    spans = span_report()["spans"]
    assert set(spans) == {"train.pretrain_step", *PRETRAIN_PHASES}
    assert all(s["calls"] == 1 for s in spans.values())


def _x4(x):
    return x.repeat_interleave(4, 1).repeat_interleave(4, 2)


def test_tiled_upscale_counts_the_tile_plan():
    frames = [(40, 48), (20, 20), (48, 33)]     # (h, w); 20 x 20 runs whole
    tile, halo = 32, 4
    with recording():
        for h, w in frames:
            tiling.tiled_upscale(_x4, torch.zeros((h, w, 3)), scale=4,
                                 tile=tile, halo=halo, tile_batch=2)
    report = span_report()
    plans = [tiling.plan_tiles(h, w, tile, halo) for h, w in frames]
    n_tiles = [len(oys) * len(oxs) for _, oys, oxs in plans]
    assert n_tiles == [4, 1, 4]
    gen_px = sum(th * tw * n if h > tile or w > tile else h * w
                 for ((th, tw), _, _), n, (h, w) in zip(plans, n_tiles,
                                                        frames))
    c = report["counters"]
    assert c["tiling.frame_lr_px"] == sum(h * w for h, w in frames)
    assert c["tiling.generator_lr_px"] == gen_px == 32 * 32 * 8 + 400
    assert c["tiling.tiles"] == 9
    spans = report["spans"]
    assert spans["tiling.tiled_upscale"]["calls"] == 3
    assert spans["tiling.extract"]["calls"] == 2
    assert spans["tiling.blend"]["calls"] == 2
    assert spans["tiling.generator"]["calls"] == 2 + 1 + 2


def test_cli_train_profile_dir_writes_spans_beside_the_trace(tmp_path):
    assert main(["train", "--device", "cpu", "--dtype", "float32",
                 "--preset", "train_gan_dfm", "--residual_blocks", "1",
                 "--batch_size", "2", "--hr_height", "32",
                 "--warmup_batches", "1", "--dataset_dir",
                 "/nonexistent/synthetic", "--steps", "2",
                 "--checkpoint_dir", str(tmp_path / "ck"), "--profile_dir",
                 str(tmp_path / "p")]) == 0
    (trace,) = glob.glob(str(tmp_path / "p" / "*.pt.trace.json"))
    path = trace[:-len(".pt.trace.json")] + ".spans.json"
    assert os.path.exists(path)
    with open(path) as f:
        spans = json.load(f)["spans"]
    assert spans["train.pretrain_step"]["calls"] == 1
    assert spans["train.gan_step"]["calls"] == 1
    assert spans["train.data_wait"]["calls"] == 2


def test_throughput_synchronises_before_it_reads_the_clock(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    meter = Throughput(n_chips=2, device="cuda")
    assert synced == [torch.device("cuda")]
    meter.add(4_000_000)
    assert meter.mp_per_sec_per_chip() > 0 and len(synced) == 2
    meter.reset()
    assert len(synced) == 3
    cpu = Throughput(device="cpu")
    cpu.add(1)
    cpu.mp_per_sec_per_chip()
    assert len(synced) == 3
