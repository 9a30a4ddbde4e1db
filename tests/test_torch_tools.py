"""The port's dense-block variant tools (``super_resolution_tpu_torch.
tools``) with ``--device cpu`` at tiny sizes, where every variant runs its
plain version: each prints a line with a time for every variant (and
band height), none prints ``FAILED``, ``--fwd_carry`` is refused, and
``kernel_dev_check`` holds every variant to its tolerance.
"""

import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch.ops import experiments_dense_block as P
from super_resolution_tpu_torch.ops.dense_block import (
    dense_block,
    pack_weight,
)
from super_resolution_tpu_torch.tools import kernel_bench, kernel_dev_check
from super_resolution_tpu_torch.tools import model_bench

ALL_BLOCKS = "lax,v3,v3b,v4,v5,v6,v8,v9"
ALL_MODELS = ",".join(["lax", "prod"] + [f"{b}+{t}" for b in model_bench.BLOCKS
                                          for t in ("laxtail", "ktail")])


def test_kernel_bench_prints_every_variant(capsys):
    assert kernel_bench.main(["--device", "cpu", "--batch", "1", "--hw",
                              "16", "--rows", "8,16",
                              "--variants", ALL_BLOCKS]) == 0
    out = capsys.readouterr().out
    assert "FAILED" not in out
    assert re.search(r"^lax\s+:\s+[\d.]+ ms", out, re.M)
    for v in ALL_BLOCKS.split(",")[1:]:
        for rows in (8, 16):
            unit = "TOP/s" if v == "v8" else "TF/s"
            assert re.search(rf"^{v} rows={rows:2d}:\s+[\d.]+ ms\s+[\d.]+ "
                             rf"{unit}\s+maxerr [\d.e+-]+\s+launches 0/call",
                             out, re.M), (v, rows)
    assert out.rstrip().splitlines()[-1].startswith("launches: {")


def test_model_bench_prints_every_variant(capsys):
    assert model_bench.main(["--device", "cpu", "--tile", "8", "--batch",
                             "1", "--iters", "1",
                             "--variants", ALL_MODELS]) == 0
    out = capsys.readouterr().out
    assert "FAILED" not in out
    for v in ALL_MODELS.split(","):
        assert re.search(rf"^{re.escape(v)}\s*:\s+[\d.]+ ms/batch\s+[\d.]+ "
                         rf"MP/s", out, re.M), v


def test_model_bench_swap_computes_the_block():
    """The v4 / v6 seam takes dense_block's packed weights and gives its
    result (the same function), at a height v4's default band divides
    and at one it does not."""
    rng = np.random.default_rng(0)
    for h in (32, 24):
        x = torch.from_numpy(rng.standard_normal((1, 16, h, 12))
                             .astype(np.float32))
        ws, bs, cin = [], [], 16
        for k in range(5):
            cout = 16 if k == 4 else 8
            ws.append(pack_weight(torch.from_numpy(
                rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)
                * 0.1)))
            bs.append(torch.from_numpy(rng.standard_normal(cout)
                                       .astype(np.float32) * 0.1))
            cin += 8
        ref = dense_block(x, ws, bs, res_scale=0.2, slope=0.2)
        for fn in (P.fused_dense_block_cf3, P.fused_dense_block_cf6):
            got = model_bench._swapped(fn)(x, ws, bs, res_scale=0.2,
                                           slope=0.2)
            assert torch.equal(got, ref)


@pytest.mark.parametrize("which", ["v3b", "v4", "v5", "v6", "v8"])
def test_kernel_dev_check_passes(which, capsys):
    assert kernel_dev_check.main([which, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert len(re.findall(rf"^{which} B\d+ C\d+ H\d+x\d+ rows\d+: max err",
                          out, re.M)) == len(kernel_dev_check.CASES)
    assert f"{which} matches the float32 block on all cases (cpu)" in out


@pytest.mark.parametrize("tool", [kernel_bench, model_bench])
def test_fwd_carry_is_refused(tool):
    with pytest.raises(SystemExit, match="not ported"):
        tool.main(["--device", "cpu", "--fwd_carry"])


def test_tools_run_as_modules():
    r = subprocess.run(
        [sys.executable, "-m",
         "super_resolution_tpu_torch.tools.kernel_dev_check", "v5",
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "v5 matches the float32 block on all cases (cpu)" in r.stdout
