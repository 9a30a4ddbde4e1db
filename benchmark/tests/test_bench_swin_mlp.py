"""The reader of ``swin_mlp.roofline.upscale`` on the CPU: its
arithmetic on a recorded counter and a kernel's device time, and None
where the program has no counter or no kernel (the parent of the
kernel, a CPU run)."""

import pytest

import super_resolution_tpu_torch.metrics as program_metrics
from benchmark.lib import harness, trace as trace_lib

CELL = "swinir_l_real_x4.sd_images"
METRIC = "swin_mlp.roofline.upscale"
KERNEL = ("void (anonymous namespace)::smlp::swin_mlp_kernel<240, 2>("
          "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
          "(anonymous namespace)::smlp::Params)")


def _measured(monkeypatch, counters, device_s):
    monkeypatch.setattr(program_metrics, "span_report",
                        lambda: {"spans": {}, "counters": counters},
                        raising=False)
    tr = trace_lib.Trace(window_s=1.0, busy_s=0.9, device_s=device_s)
    return harness.Measured(harness.load_cell(CELL), {}, {}, tr, 1)


def test_reader_is_tokens_times_the_token_bound_over_the_kernel(
        monkeypatch):
    """54 layers of a 1024² frame in 0.05 s of kernel time: each token
    4·240·480 FLOP at 989 TFLOP/s (its 960 bytes at 3.35 TB/s take
    less), 0.4659 ns."""
    tokens = 54 * 1024 * 1024
    m = _measured(monkeypatch, {"swin_mlp.tokens": tokens},
                  {KERNEL: 0.05, "nvjet_tst_144x192": 1.0})
    got = harness.reader(METRIC)(m)
    assert got == pytest.approx(100 * tokens * 460800 / 989e12 / 0.05)
    assert 460800 / 989e12 == pytest.approx(0.4659e-9, rel=1e-4)
    assert 50 < got < 100


@pytest.mark.parametrize("counters,device_s", [
    ({}, {KERNEL: 0.05}),                        # no counter: the parent
    ({"swin_mlp.tokens": 10 ** 6}, {}),          # no kernel: the CPU
    ({"swin_mlp.tokens": 10 ** 6}, {"nvjet_tst_80x384": 0.1}),
])
def test_reader_reads_none_without_counter_or_kernel(monkeypatch, counters,
                                                     device_s):
    assert harness.reader(METRIC)(_measured(monkeypatch, counters,
                                            device_s)) is None


def test_reader_is_listed_for_the_swinir_cell_alone():
    names = {c: [m["name"] for m in harness.load_cell(c).per_layer]
             for c in ("swinir_l_real_x4.sd_images",
                       "esrgan_x4_rrdb23.frame2k")}
    assert METRIC in names["swinir_l_real_x4.sd_images"]
    assert METRIC not in names["esrgan_x4_rrdb23.frame2k"]
