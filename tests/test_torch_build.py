"""How the port's CUDA sources are built, checked without a compiler:
the library name covers every shared header, the ptxas report is read
back, and the bf16 kernels sit on the Hopper tile and wgmma."""

import importlib
import inspect
import os
import shutil

import pytest

from super_resolution_tpu_torch import build

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_13wgc13conv3x3_wgmmaILi64ELi32E13__nv_bfloat16EEv14CUtensorMap_stS3_NS0_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_13wgc13conv3x3_wgmmaILi64ELi32E13__nv_bfloat16EEv14CUtensorMap_stS3_NS0_6ParamsE
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes smem, 1056 bytes cmem[0]
ptxas info    : Compiling entry function '_Z9other_fnv' for 'sm_90a'
ptxas info    : Function properties for _Z9other_fnv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 384 bytes cmem[0]
"""


def test_parse_ptxas_reads_registers_smem_and_spills():
    wg, other = build.parse_ptxas(LOG)
    assert "conv3x3_wgmma" in wg["kernel"]
    assert (wg["registers"], wg["smem_bytes"]) == (168, 1024)
    assert (wg["spill_stores"], wg["spill_loads"]) == (8, 12)
    assert len(wg["notes"]) == 1 and "serialized" in wg["notes"][0]
    assert other == {"kernel": "_Z9other_fnv", "registers": 40,
                     "smem_bytes": 0, "spill_stores": 0, "spill_loads": 0,
                     "notes": []}
    assert build.parse_ptxas("nvcc: nothing to report\n") == []


def test_every_header_is_hashed(tmp_path, monkeypatch):
    """An edited header gives every library a new name, so no stale
    library is loaded after it changes."""
    headers = sorted(f for f in os.listdir(build.CSRC) if f.endswith(".cuh"))
    assert sorted(build.HEADERS) == headers
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    before = {n: build.library_path(n) for n in build.SOURCES}
    for h in headers:
        with open(csrc / h, "a") as f:
            f.write("\n// edited\n")
        after = {n: build.library_path(n) for n in build.SOURCES}
        assert all(after[n] != before[n] for n in build.SOURCES), h
        before = after


def _source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("name", ["conv3x3.cu", "dense_block.cu",
                                  "dense_block_chain.cu"])
def test_bf16_forward_runs_on_the_wgmma_tile(name):
    src = _source(name)
    assert '#include "conv3x3_wgmma.cuh"' in src
    assert "conv_tile_bf16" not in src
    assert "wgc::launch<__nv_bfloat16" in src


@pytest.mark.parametrize("name,epilogues", [
    ("dense_block_chain.cu", "WGC_EPILOGUE_CHAIN"),
    ("conv3x3.cu", None), ("dense_block.cu", None),
    ("dense_block_bwd.cu", None)])
def test_each_source_compiles_the_epilogues_it_launches(name, epilogues):
    """Only the trunk's chain compiles the chained epilogue (beside the
    store); the other sources keep the default set, the code they had
    before it (the backward has its own epilogue)."""
    src = _source(name)
    define = f"#define WGC_EPILOGUE {epilogues}"
    if epilogues is None:
        assert "#define WGC_EPILOGUE" not in src
    else:
        assert define in src
        assert src.index(define) < src.index('#include "conv3x3_wgmma.cuh"')
    hopper = _source("conv3x3_wgmma.cuh")
    assert "!compiled(c.mode)" in hopper      # launch refuses the others


def test_mma_sync_tile_serves_only_the_backward():
    """The bf16 mma.sync tile is gone with its last user: the bf16
    backward's data gradient runs on the Hopper tile (its own epilogues)
    and its weight gradient on wgmma fed by TMA; the wrapper re-lays the
    weights with one indexed copy, not a flip and a transpose per conv."""
    users = [n for n in os.listdir(build.CSRC)
             if "conv_tile_bf16" in _source(n)
             or "mma.sync.aligned.m16n8k16" in _source(n)]
    assert users == []
    bwd = _source("dense_block_bwd.cu")
    assert '#include "conv3x3_wgmma.cuh"' in bwd
    assert "wgc::launch<float, 64, true>" in bwd
    for ptx in ("wgmma.mma_async", "ldmatrix.sync.aligned.m8n8.x4.trans",
                "wgc::tma_load_4d"):
        assert ptx in bwd
    hopper = _source("conv3x3_wgmma.cuh")
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor.4d",
                "mbarrier.try_wait", "ldmatrix"):
        assert ptx in hopper
    ops = importlib.import_module(
        "super_resolution_tpu_torch.ops.dense_block")
    bf16_path = inspect.getsource(ops._bwd_bf16)
    assert "flip(" not in bf16_path and "transpose(" not in bf16_path
    assert "torch.zeros" not in bf16_path      # no f32 dfeats buffer
