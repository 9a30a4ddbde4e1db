"""The SwinIR cell (``swinir_l_real_x4.sd_images``) on the CPU: the
counts of ``flops_swinir`` and ``weights_swinir``, a tiny SwinIR cell run
through the whole harness in float32, and the generic frame readers and
the new readers on what the ``swinir_frames`` driver records."""

import dataclasses

import pytest
from torch.profiler import record_function

import super_resolution_tpu_torch.config as program_config
import super_resolution_tpu_torch.metrics as program_metrics
from benchmark.lib import harness, trace as trace_lib, traffic
from benchmark.lib.flops_swinir import flops_per_lr_px, macs_per_lr_px
from benchmark.lib.weights_swinir import n_parameters
from benchmark.tests._tiny import CPU
from super_resolution_tpu_torch.parallel.tiling import plan_tiles

CELL = "swinir_l_real_x4.sd_images"
TINY = dict(embed_dim=60, depths=[2, 2], num_heads=[2, 2],
            compute_dtype="float32")


def test_counts_of_swinir_l():
    cfg = harness.load_cell(CELL).config
    assert n_parameters(cfg) == cfg["parameters"] == 28013059
    macs = macs_per_lr_px(cfg)
    assert macs["total"] == 30669552
    assert macs["linears"] + macs["attention"] == 26542080
    assert flops_per_lr_px(cfg) == 2 * 30669552


@pytest.fixture
def tiny_cell(monkeypatch):
    """SwinIR at embed 60, two RSTBs of two layers, float32, on frames of
    40 x 48 and 20 x 28 with tile 32: the program's preset cut to the
    same architecture."""
    cell = harness.load_cell(CELL)
    real = program_config.preset

    def preset(name):
        p = real(name)
        if name == "swinir_l_real_x4":
            p = dataclasses.replace(p, generator=dataclasses.replace(
                p.generator, embed_dim=60, depths=(2, 2), num_heads=(2, 2)))
        return p

    monkeypatch.setattr(program_config, "preset", preset)
    return dataclasses.replace(
        cell, config=dict(cell.config, **TINY),
        traffic=dict(cell.traffic, tile=32, halo=4, warmup_frames=3,
                     trace_count=3,
                     sizes=[{"w": 40, "h": 48, "per_cycle": 2},
                            {"w": 20, "h": 28, "per_cycle": 1}]))


def test_tiny_cell_is_correct_on_the_cpu(tiny_cell):
    import time

    res = harness.run(tiny_cell, 2 ** 31 + 12345, 0.2, False, CPU,
                      time.perf_counter())
    assert res["correct"]
    # float32 in other orders: a rare uint8 rounding flips at .5
    assert res["checks"]["sr_mean_abs_lsb"]["value"] < 0.01


def test_edge_number_reads_the_worst_side():
    """``sr_edge_mean_abs_max_lsb``: 4 steps on every pixel of a 16-row
    band along one side read 4, where the 128² block that holds it reads
    a quarter of that; a frame of the wrong shape reads infinity."""
    import numpy as np
    import torch

    from benchmark.drivers.swinir_frames import EDGE, EdgeFrameErrors

    ref = torch.full((256, 192, 3), 100, dtype=torch.uint8)
    prog = ref.numpy().copy()
    prog[-EDGE:] += 4
    errs = EdgeFrameErrors()
    errs.add(prog, ref)
    n = errs.numbers()
    assert n["sr_edge_mean_abs_max_lsb"] == pytest.approx(4.0)
    assert n["sr_block_mean_abs_max_lsb"] == pytest.approx(4.0 * EDGE / 128)
    errs.add(np.zeros((8, 8, 3), np.uint8), ref)
    assert errs.numbers()["sr_edge_mean_abs_max_lsb"] == float("inf")


def _report(monkeypatch, spans=None, counters=None):
    monkeypatch.setattr(program_metrics, "span_report",
                        lambda: {"spans": spans or {},
                                 "counters": counters or {}},
                        raising=False)


def test_readers_read_the_swinir_driver(tiny_cell):
    """A traced run of the tiny cell: the recompute counter over the
    traced cycle, ``mfu.swinir.upscale`` from the window; the device
    readers read nothing on the CPU."""
    t = tiny_cell.traffic
    drv = harness.driver("swinir_frames")(tiny_cell.config, t, 7, CPU)
    drv.warmup()
    window = drv.run(0.1)
    with trace_lib.profiled(CPU) as prof:
        with record_function(trace_lib.WINDOW):
            traced = drv.run(None, count=t["trace_count"], traced=True)
    m = harness.Measured(tiny_cell, window, traced, trace_lib.reduce(prof), 1)
    sizes = traffic.frame_cycle(t)

    def gen_px(w, h):
        (th, tw), oys, oxs = plan_tiles(h, w, t["tile"], t["halo"])
        return h * w if h <= t["tile"] and w <= t["tile"] else \
            len(oys) * len(oxs) * th * tw

    want = sum(gen_px(w, h) for w, h in sizes) / sum(w * h for w, h in sizes)
    assert harness.reader("tiling.recompute.upscale")(m) == want
    mfu = harness.reader("mfu.swinir.upscale")(m)
    assert mfu == pytest.approx(100 * window["lr_px"] * flops_per_lr_px(
        tiny_cell.config) / window["window_s"] / 67e12)
    for name in ("tiling.self.upscale", "tiling.outside_generator.upscale",
                 "window_attention.roofline.upscale",
                 "window_attention.share.upscale"):
        assert harness.reader(name)(m) is None, name


def _measured(cell, traced=None, device_s=None):
    tr = trace_lib.Trace(window_s=1.0, busy_s=0.9, device_s=device_s or {})
    return harness.Measured(harness.load_cell(cell), {}, traced or {}, tr, 1)


def test_window_attention_readers(monkeypatch):
    _report(monkeypatch,
            spans={"ops.window_attention": {"calls": 54, "host_s": 0.01,
                                            "self_host_s": 0.01,
                                            "device_s": 0.5}},
            counters={"window_attention.windows": 10 ** 6})
    kernel = "(anonymous namespace)::window_attention_kernel(Params)"
    m = _measured(CELL, traced={"frame_wall_s": 2.0},
                  device_s={kernel: 0.01})
    # 1e6 window-heads x 15,360 bytes at 3.35 TB/s over 10 ms
    assert harness.reader("window_attention.roofline.upscale")(m) == \
        pytest.approx(100 * 1e6 * 15360 / 3.35e12 / 0.01)
    assert harness.reader("window_attention.share.upscale")(m) == \
        pytest.approx(25.0)
    _report(monkeypatch)
    assert harness.reader("window_attention.roofline.upscale")(m) is None

