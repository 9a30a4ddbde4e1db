"""The harness itself: names and units, discovery of every cell's and
metric's files, the import check, the refusal without a card, and the
comparison that decides ``correct`` failing the control and the faults
that a cell can have."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark.lib import compare, harness, program
from benchmark.drivers.frames import Driver as Frames
from benchmark.drivers.gan_train import Driver as Training
from benchmark.tests._tiny import CPU, frame_cell, train_cell

BENCH = harness.BENCH
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.spec()


def _texts(spec):
    for c in spec["configs"]:
        yield c["why"]
        yield c["source"]
    for w in spec["workloads"]:
        yield w["why"]
    for m in spec["per_layer"]:
        yield m["layer"]
    yield from spec["command"]


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w[k] for w in SPEC["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in _texts(SPEC):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_contract_keys_and_bounds():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_every_cell_and_metric_resolves_to_its_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        used.add(w["config"])
        assert callable(harness.driver(cell.traffic["kind"]))
        assert os.path.exists(os.path.join(ROOT, configs[w["config"]]["file"]))
        assert compare.load_limits(w["name"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(harness.reader(m["name"]))
    assert used == set(configs)
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_in_the_harness_sources():
    found = []
    for base, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(base, f)):
                    if mod.split(".")[0] in harness.FORBIDDEN:
                        found.append((f, mod))
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert "super_resolution_tpu_torch" not in tops, f


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import super_resolution_tpu_torch  # noqa: F401

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "super_resolution_tpu.cli", object())
    assert harness.forbidden_modules() == ["super_resolution_tpu"]


def test_no_card_no_run():
    """Without a card the command fails and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for w in SPEC["workloads"]:
        p = subprocess.run(
            [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
             w["name"], "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0
        assert "{" not in p.stdout
        assert "no run" in p.stderr


def test_a_cpu_run_reports_no_device_metric():
    cell = frame_cell()
    r = harness.run(cell, 5, 0.5, False, CPU, 0.0)
    assert r["metrics"] == {} and r["device"]["platform"] == "cpu"
    assert r["correct"] and list(r)[-1] == "checks"
    r = harness.run(cell, 6, 0.5, True, CPU, 0.0)
    assert r["metrics"] == {} and "breakdown" not in r


def _judge(cell, numbers):
    return compare.judge(numbers, compare.load_limits(cell.name))[0]


@pytest.mark.parametrize("name", ["esrgan_x4_rrdb23.frame2k",
                                  "realesrgan_x4_anime6b.frames_mixed"])
def test_frames_sound_altered_and_control(name, monkeypatch):
    """A sound run is correct; an answer altered where it is produced
    (one tile's SR) and the control (the reference in fp8) are not."""
    cell = frame_cell(name)
    assert harness.run(cell, 21, 0.3, False, CPU, 0.0)["correct"]

    real = program.Upscaler.__init__

    def altered(self, *a, **k):
        real(self, *a, **k)
        infer = self.infer
        calls = [0]

        def bad(x):
            y = infer(x)
            calls[0] += 1
            if calls[0] % 3 == 0:
                y = y.clone()
                y[0] += 0.25
            return y

        self.infer = bad

    monkeypatch.setattr(program.Upscaler, "__init__", altered)
    assert not harness.run(cell, 22, 0.3, False, CPU, 0.0)["correct"]


@pytest.mark.parametrize("name", ["esrgan_x4_rrdb23.frame2k",
                                  "realesrgan_x4_anime6b.frames_mixed"])
def test_frames_control_reads_above_the_program(name):
    """At a size a test holds (published widths, two blocks, small
    frames), the control (the reference in fp8) reads at least three
    times what the program's bfloat16 path reads, on each number."""
    cell = frame_cell(name, "bfloat16")
    drv = Frames(cell.config, cell.traffic, 24, CPU)
    drv.run(None, count=3)
    drv.free_program()
    prog, ctrl = drv.check(), drv.candidate("control")
    assert all(ctrl[k] >= 3 * prog[k] for k in prog), (prog, ctrl)


def test_training_sound_and_control():
    """A sound run is correct; the control (the reference in fp8) is not
    on most seeds, as on the card (PERF.md: 23 of 27 seeds)."""
    cell = train_cell()
    assert harness.run(cell, 31, 0.3, False, CPU, 0.0)["correct"]
    passed = [_judge(cell, Training(cell.config, cell.traffic, seed, CPU,
                                    build_program=False).candidate("control"))
              for seed in (32, 41, 50, 51, 52)]
    assert sum(passed) <= 2, passed


@pytest.mark.parametrize("name,number", [("g_grad_x2", "grad_gap_g_worst"),
                                         ("no_vgg", "percep_gap_step1")])
def test_training_planted_faults(name, number):
    """G's gradient doubled reads 1 on its worst leaf; a step without
    VGG reads 1 on the perceptual loss; the limits fail both."""
    cell = train_cell()
    drv = Training(cell.config, cell.traffic, 36, CPU, build_program=False)
    numbers = drv.candidate(name)
    assert abs(numbers[number] - 1.0) < 1e-5, numbers
    assert not _judge(cell, numbers)


def test_training_state_left_unchanged(monkeypatch):
    """A step that returns its state unchanged: no update, no EMA."""
    import super_resolution_tpu_torch.train.steps as steps

    monkeypatch.setattr(steps, "apply_update", lambda *a, **k: None)
    monkeypatch.setattr(steps, "ema_update", lambda *a, **k: None)
    r = harness.run(train_cell(), 33, 0.3, False, CPU, 0.0)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] > 0.99


def test_training_half_the_batch_left_out(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    real = program.GANTrainer.step
    monkeypatch.setattr(program.GANTrainer, "step",
                        lambda self, hr: real(self, hr[:hr.shape[0] // 2]))
    assert not harness.run(train_cell(), 34, 0.3, False, CPU, 0.0)["correct"]


def _two_ranks(rank_, port, cut_exchange, path):
    from benchmark.lib import ranks

    torch.set_num_threads(1)
    if cut_exchange:
        import super_resolution_tpu_torch.train.steps as steps

        steps.average_gradients = list
    ranks.join(rank_, 2, port, CPU)
    try:
        r = harness.run(train_cell(batch=4), 35, 0.3, False, CPU, 0.0,
                        compare.load_limits("esrgan_x4_rrdb23.train_gan"))
    finally:
        ranks.leave()
    if rank_ == 0:
        with open(path, "w") as f:
            json.dump(r, f)


@pytest.mark.parametrize("cut_exchange", [False, True])
def test_training_on_two_ranks(cut_exchange, tmp_path):
    """Two gloo ranks, each feeding half of every global batch: rank 0
    reports the global step as correct, and a step whose ranks never
    exchange their gradients as not correct."""
    from benchmark.lib import ranks

    path = tmp_path / "result.json"
    torch.multiprocessing.spawn(
        _two_ranks, (ranks.free_port(), cut_exchange, str(path)), nprocs=2)
    r = json.loads(path.read_text())
    assert r["correct"] is (not cut_exchange), r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", name,
         "--seed", "977", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    cell = harness.load_cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
