"""The readers of the program's spans and counters
(``metrics/tiling.recompute.upscale.py``, ``tiling.self.upscale.py``,
``dense_block.wrapper.upscale.py``, ``optimizer.share.train.py``) on
fabricated reports, without the program's spans (a parent that has
none), and the recompute ratio from a traced run on the CPU."""

import importlib.util
import os

import pytest
from torch.profiler import record_function

import super_resolution_tpu_torch.metrics as program_metrics
from benchmark.drivers.frames import Driver as Frames
from benchmark.lib import harness, trace as trace_lib, traffic
from benchmark.tests._tiny import CPU, frame_cell
from super_resolution_tpu_torch.parallel.tiling import plan_tiles

READERS = ("tiling.recompute.upscale", "tiling.self.upscale",
           "dense_block.wrapper.upscale", "optimizer.share.train")
KERNEL = "wgc::conv3x3_wgmma<32, 32, __nv_bfloat16, false>"


def _measured(traced=None, device_s=None):
    cell = harness.load_cell("esrgan_x4_rrdb23.frame2k")
    tr = trace_lib.Trace(window_s=1.0, busy_s=0.9,
                         device_s=device_s or {})
    return harness.Measured(cell, {}, traced or {}, tr, 1)


def _report(monkeypatch, spans=None, counters=None):
    monkeypatch.setattr(program_metrics, "span_report",
                        lambda: {"spans": spans or {},
                                 "counters": counters or {}},
                        raising=False)


def _generator_px(w: int, h: int, tile: int, halo: int) -> int:
    """LR pixels the generator runs over for one frame."""
    (th, tw), oys, oxs = plan_tiles(h, w, tile, halo)
    if h <= tile and w <= tile:
        return h * w
    return len(oys) * len(oxs) * th * tw


@pytest.mark.parametrize("mix,ratio", [("frames_mixed", 1.5197),
                                       ("frame2k", 1.2656)])
def test_recompute_of_the_mixes_cycles(monkeypatch, mix, ratio):
    t = traffic.load(mix)
    sizes = traffic.frame_cycle(t) * 2          # the traced part's cycles
    _report(monkeypatch, counters={
        "tiling.frame_lr_px": sum(w * h for w, h in sizes),
        "tiling.generator_lr_px": sum(_generator_px(w, h, t["tile"],
                                                    t["halo"])
                                      for w, h in sizes)})
    value = harness.reader("tiling.recompute.upscale")(_measured())
    assert round(value, 4) == ratio
    if mix == "frames_mixed":        # 480p, the largest by frame size
        assert round(_generator_px(854, 480, 384, 8) / (854 * 480),
                     3) == 2.158


def test_tiling_self_time(monkeypatch):
    _report(monkeypatch, spans={
        "tiling.tiled_upscale": {"calls": 2, "host_s": 0.5,
                                 "self_host_s": 0.1, "device_s": 0.45},
        "tiling.generator": {"calls": 8, "host_s": 0.4,
                             "self_host_s": 0.4, "device_s": 0.4}})
    m = _measured(traced={"frame_wall_s": 2.5})
    assert harness.reader("tiling.self.upscale")(m) == pytest.approx(2.0)


def test_dense_block_wrapper_share(monkeypatch):
    _report(monkeypatch, spans={
        "ops.dense_block": {"calls": 69, "host_s": 0.2, "self_host_s": 0.2,
                            "device_s": 1.25}})
    m = _measured(device_s={KERNEL: 1.0, "elementwise_kernel": 0.5})
    assert harness.reader("dense_block.wrapper.upscale")(m) == \
        pytest.approx(20.0)


def test_the_wrapper_reads_the_rooflines_kernels():
    def kernels(name):
        path = os.path.join(harness.BENCH, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.KERNELS

    assert kernels("dense_block.wrapper.upscale") == \
        kernels("dense_block.roofline.upscale")


def test_optimizer_share(monkeypatch):
    row = {"calls": 8, "self_host_s": 0.0}
    _report(monkeypatch, spans={
        "train.gan_step": {**row, "host_s": 2.0},
        "train.adam_g": {**row, "host_s": 0.3},
        "train.adam_d": {**row, "host_s": 0.05},
        "train.ema": {**row, "host_s": 0.05}})
    assert harness.reader("optimizer.share.train")(_measured()) == \
        pytest.approx(20.0)


def test_no_spans_no_value(monkeypatch):
    """A program without spans (the parent of the change that added
    them), an empty report, or an untraced run: every reader returns
    None and raises nothing."""
    m = _measured(traced={"frame_wall_s": 1.0}, device_s={KERNEL: 1.0})
    monkeypatch.delattr(program_metrics, "span_report")
    assert [harness.reader(n)(m) for n in READERS] == [None] * 4
    _report(monkeypatch)
    assert [harness.reader(n)(m) for n in READERS] == [None] * 4
    _report(monkeypatch, counters={"tiling.frame_lr_px": 1,
                                   "tiling.generator_lr_px": 2})
    m.trace = None
    assert [harness.reader(n)(m) for n in READERS] == [None] * 4


def test_recompute_after_a_traced_run_on_the_cpu():
    """The report covers the traced part alone: the untraced window
    before it adds nothing."""
    cell = frame_cell()
    t = cell.traffic
    drv = Frames(cell.config, t, 7, CPU)
    drv.warmup()
    window = drv.run(0.2)
    with trace_lib.profiled(CPU) as prof:
        with record_function(trace_lib.WINDOW):
            traced = drv.run(None, count=t["trace_count"], traced=True)
    m = harness.Measured(cell, window, traced, trace_lib.reduce(prof), 1)
    sizes = traffic.frame_cycle(t)          # trace_count: one whole cycle
    assert len(sizes) == t["trace_count"]
    want = sum(_generator_px(w, h, t["tile"], t["halo"])
               for w, h in sizes) / sum(w * h for w, h in sizes)
    assert harness.reader("tiling.recompute.upscale")(m) == want
    # the CPU records no device time
    assert harness.reader("tiling.self.upscale")(m) is None
