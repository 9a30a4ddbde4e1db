"""The RRDB trunk on the chain (``ops.dense_block.dense_block_chain``,
``RRDBNet.trunk``) on the CPU: its buffer plan, its plain version held
bit for bit to the trunk block by block (``model.body``) in bf16 and
float32 at small widths, its counters, and the paths that keep the
per-block trunk.  The card's kernels are held to the same trunk in
``tests/test_torch_cuda.py``."""

import pytest
import torch

from super_resolution_tpu_torch.config import GeneratorConfig
from super_resolution_tpu_torch.metrics import recording, span_report
from super_resolution_tpu_torch.models import rrdb
from super_resolution_tpu_torch.ops.dense_block import (
    CHAIN_BUFFERS,
    chain_plan,
    dense_block,
    dense_block_chain,
)


@pytest.mark.parametrize("n_rrdb", [1, 2, 5])
@pytest.mark.parametrize("n_dense", [1, 2, 3, 4])
def test_chain_plan_never_writes_what_is_still_read(n_rrdb, n_dense):
    plan = chain_plan(n_rrdb, n_dense)
    assert len(plan) == n_rrdb * n_dense
    assert plan[0][0] == 0
    for i, (src, dst, outer) in enumerate(plan):
        end = i % n_dense == n_dense - 1
        first = plan[i - i % n_dense][0]
        assert {src, dst} | {outer} - {None} <= set(range(CHAIN_BUFFERS))
        assert dst != src                       # other tiles still read src
        assert outer == (first if end else None)
        if not end:
            assert dst != first                 # x_o waits there
        elif src != first:
            assert dst == first                 # x_o written over in place
        if i + 1 < len(plan):
            assert plan[i + 1][0] == dst        # the next block reads it


def _model(dtype, impl="auto", seed=0, **kw):
    cfg = GeneratorConfig(n_blocks=3, init="torch_default", conv_impl=impl,
                          **kw)
    return rrdb.RRDBNet(cfg, torch.Generator().manual_seed(seed)) \
        .prepare(dtype)


def _trunks(model, dtype, c, hw=16):
    """(model.trunk, model.body, counters of the trunk) on a seeded map."""
    fea = torch.randn(2, c, hw, hw, generator=torch.Generator()
                      .manual_seed(7)).to(dtype)
    with torch.no_grad():
        ref = model.body(fea)
        with recording():
            got = model.trunk(fea)
            counters = span_report()["counters"]
    return got, ref, counters


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kw", [
    dict(filters=16, growth=8, n_dense_convs=3),
    dict(filters=16, growth=8, n_dense_convs=5),
    # padded in bf16: C 12 -> 16, G 6 -> 8
    dict(filters=12, growth=6, n_dense_convs=5),
    dict(filters=16, growth=8, n_dense=1),
    dict(filters=16, growth=8, n_dense=2, n_dense_convs=4)],
    ids=["convs3", "convs5", "padded", "one_block", "two_blocks"])
def test_chain_plain_is_the_per_block_trunk_bit_for_bit(dtype, kw):
    model = _model(dtype, **kw)
    fea = torch.randn(2, kw["filters"], 16, 16, generator=torch.Generator()
                      .manual_seed(7)).to(dtype)
    blocks = [[(d._w, d._b) for d in r.dense_blocks()] for r in model.body]
    with torch.no_grad(), recording():
        got = dense_block_chain(fea, blocks, res_scale=0.2, slope=0.2)
        counters = span_report()["counters"]
        ref = model.body(fea)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, ref)
    n = 3 * kw.get("n_dense", 3)
    assert counters["dense_block.chained"] == n - 1
    assert counters["dense_block.input_copies"] == 1
    assert counters["launches.dense_block"] == 0     # the plain version


@pytest.mark.parametrize("impl", ["auto", "pallas_cf", "pallas_cf_tail"])
def test_bf16_model_takes_the_chain(impl):
    model = _model(torch.bfloat16, impl, filters=16, growth=8)
    got, ref, counters = _trunks(model, torch.bfloat16, 16)
    assert torch.equal(got, ref)
    assert counters["dense_block.chained"] == 8
    assert counters["dense_block.input_copies"] == 1
    x = torch.randn(1, 12, 12, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), recording():
        out = model(x)
        assert span_report()["counters"]["dense_block.chained"] == 8
    assert out.shape == (1, 48, 48, 3) and torch.isfinite(out).all()


def _no_chain(model, dtype, c):
    got, ref, counters = _trunks(model, dtype, c)
    assert torch.equal(got, ref)
    assert counters.get("dense_block.chained", 0) == 0
    assert counters.get("dense_block.input_copies", 0) == 0


@pytest.mark.parametrize("impl", ["auto", "pallas_cf_tail"])
def test_float32_keeps_the_per_block_trunk(impl):
    _no_chain(_model(torch.float32, impl, filters=16, growth=8),
              torch.float32, 16)


@pytest.mark.parametrize("impl", ["lax", "pallas_fused", "pallas"])
def test_other_impls_keep_their_trunk(impl):
    model = _model(torch.bfloat16, impl, filters=16, growth=8)
    # pallas and pallas_fused run NHWC inside: trunk their own layout
    c_axis = 3 if impl in rrdb.NHWC_IMPLS else 1
    fea = torch.randn(2, 16, 16, 16).to(torch.bfloat16)
    if c_axis == 3:
        fea = fea.permute(0, 2, 3, 1).contiguous()
    with torch.no_grad(), recording():
        got = model.trunk(fea)
        counters = span_report()["counters"]
        ref = model.body(fea)
    assert torch.equal(got, ref)
    assert counters.get("dense_block.chained", 0) == 0
    assert counters.get("dense_block.input_copies", 0) == 0


def test_live_training_keeps_the_per_block_trunk():
    cfg = GeneratorConfig(n_blocks=2, filters=16, growth=8,
                          init="torch_default")
    model = rrdb.RRDBNet(cfg, torch.Generator().manual_seed(0))
    model.prepare(torch.bfloat16, live=True)
    x = torch.randn(1, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    with recording():
        out = model(x)
        out.float().square().mean().backward()
        counters = span_report()["counters"]
    assert counters.get("dense_block.chained", 0) == 0
    assert counters.get("dense_block.input_copies", 0) == 0
    assert model.body[0].rdb1.conv1.weight.grad is not None


def test_a_block_put_in_dense_blocks_place_keeps_the_per_block_trunk(
        monkeypatch):
    """A check that swaps the module's dense_block sees every block call."""
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return dense_block(*a, **k)

    model = _model(torch.bfloat16, filters=16, growth=8)
    monkeypatch.setattr(rrdb, "dense_block", counted)
    _no_chain(model, torch.bfloat16, 16)
    assert len(calls) == 2 * 9                   # trunk and body
    x = torch.randn(1, 8, 8, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        swapped = model(x)
    monkeypatch.undo()
    with torch.no_grad():
        chained = model(x)
    assert torch.equal(swapped, chained)


def test_chain_checks_its_blocks():
    model = _model(torch.bfloat16, filters=16, growth=8)
    blocks = [[(d._w, d._b) for d in r.dense_blocks()] for r in model.body]
    fea = torch.zeros(1, 16, 8, 8, dtype=torch.bfloat16)
    assert dense_block_chain(fea, [], res_scale=0.2, slope=0.2) is fea
    with pytest.raises(ValueError, match="same number"):
        dense_block_chain(fea, [blocks[0], blocks[1][:2]], res_scale=0.2,
                          slope=0.2)
    with pytest.raises(ValueError, match="must be packed"):
        dense_block_chain(fea[:, :8].contiguous(), blocks, res_scale=0.2,
                          slope=0.2)
    other = _model(torch.bfloat16, filters=16, growth=4)
    mixed = [blocks[0], [(d._w, d._b)
                         for d in other.body[1].dense_blocks()]]
    with pytest.raises(ValueError, match="first one's"):
        dense_block_chain(fea, mixed, res_scale=0.2, slope=0.2)
