"""The port's halo sweep (``super_resolution_tpu_torch.halo_sweep``)
against the JAX package's on the CPU: the probe bit for bit, the
admissible pick on the JAX test's rows, the sweep and the val contract
on one seeded torch-spec generator (nb = 1, nf = 16, gc = 8) loaded into
both, float32, and sidecars that each package writes and the other
reads.

Tolerance: the same admissible halo, and each row's tiled-vs-whole PSNR
within 0.1 dB wherever either side is below 100 dB (above it the
deviation is float32 summation order, not truncation); the val
contract's PSNR against the ground truth within 1e-3 dB.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from super_resolution_tpu import halo_sweep as jhs
from super_resolution_tpu.import_torch import (
    import_generator as jax_import_generator,
)
from super_resolution_tpu.import_torch import load_pth as jax_load_pth
from super_resolution_tpu.models import RRDBNet as JRRDBNet
from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.config import TrainConfig
from super_resolution_tpu_torch.halo_sweep import (
    read_admissible_halo,
    read_halo_meta,
    select_admissible,
    structured_probe,
    sweep_admissible_halo,
    val_dir_contract,
    write_halo_meta,
)
from super_resolution_tpu_torch.import_torch import import_generator, load_pth
from super_resolution_tpu_torch.train.steps import make_infer_fn
from torch_spec import RRDBNetTorch

SWEEP = dict(scale=4, frame=96, tile_w=32, halos=(2, 4, 8),
             threshold_db=55.0)


@pytest.fixture(scope="module")
def gen(tmp_path_factory):
    """(.pth path, port infer, JAX infer) of one seeded generator."""
    root = tmp_path_factory.mktemp("halo")
    torch.manual_seed(0)
    pth = str(root / "gen.pth")
    torch.save(RRDBNetTorch(nf=16, nb=1, gc=8).state_dict(), pth)
    sd, gcfg = import_generator(load_pth(pth))
    cfg = TrainConfig(generator=gcfg, compute_dtype="float32")
    port = make_infer_fn(cfg, sd, "cpu")
    jv, jcfg = jax_import_generator(jax_load_pth(pth))
    jmodel = JRRDBNet(jcfg)
    jax_infer = jax.jit(lambda x: jmodel.apply(jv, x))
    return pth, port, jax_infer


@pytest.mark.parametrize("frame,seed", [(64, 0), (96, 3), (33, 7)])
def test_probe_equals_jax_bit_for_bit(frame, seed):
    got = structured_probe(frame, seed)
    assert got.dtype == np.float32 and got.shape == (frame, frame, 3)
    np.testing.assert_array_equal(got, jhs.structured_probe(frame, seed))


def test_select_admissible_requires_passing_suffix():
    """The JAX test's rows: a small halo that passes while a larger one
    fails is probe noise; the pick is the smallest halo of the largest
    passing suffix."""
    rows = [{"halo": 2, "psnr_vs_whole_db": 56.0},
            {"halo": 4, "psnr_vs_whole_db": 54.0},
            {"halo": 6, "psnr_vs_whole_db": 57.0},
            {"halo": 8, "psnr_vs_whole_db": 60.0}]
    assert select_admissible(rows, 55.0) == 6
    rows = [{"halo": 2, "psnr_vs_whole_db": 50.0},
            {"halo": 4, "psnr_vs_whole_db": 56.0},
            {"halo": 8, "psnr_vs_whole_db": 60.0}]
    for threshold, want in ((55.0, 4), (90.0, None), (40.0, 2)):
        assert select_admissible(rows, threshold) == want
        assert jhs.select_admissible(rows, threshold) == want


def test_sweep_matches_jax(gen):
    _, port, jax_infer = gen
    got = sweep_admissible_halo(port, device="cpu", **SWEEP)
    ref = jhs.sweep_admissible_halo(jax_infer, **SWEEP)
    assert got["admissible_halo"] == ref["admissible_halo"]
    assert got["admissible_halo"] in (2, 4, 8)
    for k in ("threshold_db", "frame", "tile_w", "scale", "method"):
        assert got[k] == ref[k], k
    assert [r["halo"] for r in got["sweep"]] == [2, 4, 8]
    for g, r in zip(got["sweep"], ref["sweep"]):
        assert set(g) == set(r)
        if min(g["psnr_vs_whole_db"], r["psnr_vs_whole_db"]) < 100.0:
            assert abs(g["psnr_vs_whole_db"] - r["psnr_vs_whole_db"]) \
                <= 0.1, (g, r)


def test_sweep_edges():
    with pytest.raises(ValueError, match="must exceed tile_w"):
        sweep_admissible_halo(lambda x: x, frame=32, tile_w=32,
                              device="cpu")


def test_val_dir_contract_matches_jax_and_skips_small(gen, tmp_path,
                                                      capsys):
    _, port, jax_infer = gen
    rng = np.random.default_rng(0)
    for name, side in (("a", 48), ("b", 16), ("c", 44)):
        Image.fromarray(rng.integers(0, 256, (side, side, 3),
                                     dtype=np.uint8)).save(
            tmp_path / f"{name}.png")
    got = val_dir_contract(port, str(tmp_path), scale=4, halo=2, tile_w=8,
                           device="cpu")
    out = capsys.readouterr().out
    # b's LR has 4 rows, not above 2 * halo
    assert "skipping" in out and "b.png" in out and "LR 4x4" in out
    ref = jhs.val_dir_contract(jax_infer, str(tmp_path), scale=4, halo=2,
                               tile_w=8)
    assert set(got) == set(ref)
    assert got["n_images"] == ref["n_images"] == 2
    for k in ("psnr_gt_whole_db", "psnr_gt_tiled_db", "delta_db"):
        assert got[k] == pytest.approx(ref[k], abs=1e-3), k
    none = val_dir_contract(port, str(tmp_path), scale=4, halo=8,
                            device="cpu")
    assert none["n_images"] == 0 and "note" in none


def test_sidecar_written_by_one_package_reads_in_the_other(tmp_path):
    meta = {"admissible_halo": 4, "threshold_db": 55.0, "frame": 96,
            "sweep": [{"halo": 4, "psnr_vs_whole_db": 61.25}]}
    port_rel, jax_rel = str(tmp_path / "p.pth"), str(tmp_path / "j.pth")
    write_halo_meta(port_rel, meta)
    jhs.write_halo_meta(jax_rel, meta)
    with open(port_rel + ".meta.json") as f, \
            open(jax_rel + ".meta.json") as g:
        assert f.read() == g.read()
    assert jhs.read_halo_meta(port_rel) == meta
    assert read_halo_meta(jax_rel) == meta
    assert read_admissible_halo(jax_rel) == 4
    d = tmp_path / "dir"
    d.mkdir()
    write_halo_meta(str(d), {"admissible_halo": None})
    assert jhs.read_admissible_halo(str(d)) is None


def test_export_sweep_then_upscale_auto(gen, tmp_path, capsys):
    """``cli export`` stamps the sweep by default; ``upscale``'s default
    ``--halo auto`` reads it back."""
    pth = gen[0]
    out = str(tmp_path / "release.pth")
    assert main(["export", "--checkpoint", pth, "--out", out,
                 "--sweep_frame", "96", "--sweep_tile_w", "32",
                 "--sweep_halos", "2,4,8", "--device", "cpu"]) == 0
    with open(out + ".meta.json") as f:
        meta = json.load(f)
    assert meta["method"] == "structured_probe_sweep"
    assert meta["weights"] == "params" and len(meta["sweep"]) == 3
    assert meta["admissible_halo"] in (2, 4, 8)
    capsys.readouterr()
    src = str(tmp_path / "in.png")
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (40, 40, 3), dtype=np.uint8)).save(src)
    assert main(["upscale", "--image", src, "--checkpoint", out, "--out",
                 str(tmp_path / "sr.png"), "--tile", "32", "--device", "cpu",
                 "--dtype", "float32"]) == 0
    assert (f"halo={meta['admissible_halo']} from release metadata"
            in capsys.readouterr().out)
