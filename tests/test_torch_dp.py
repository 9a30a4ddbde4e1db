"""Data parallelism of the port (``parallel/dp.py``) on the CPU: two gloo
ranks, spawned with ``torch.multiprocessing`` and meeting at a
``file://`` store under the test's own directory (so xdist workers never
share a port), each with half of a global batch of 4 HR patches 32 × 32,
against one process with the 4 rows.

The model is tiny (1 RRDB, 8 / 4, D of two scales at width 8), float32,
``torch_default`` init (a near-constant SR image makes BatchNorm's
E[x²] − E[x]² cancel, and summation order alone then moves gradients),
the D-feature-matching perceptual term (its normaliser is a global
mean), augmentation on (its decisions are drawn for the global batch).

Tolerances are the JAX package's for its sharded steps
(``tests/test_dp.py:70-97``): the pretrain step's loss 1e-6 and
parameters 1e-5; the GAN step's losses 5e-4, G and D parameters and D's
running statistics 1e-3; three pretrain steps 1e-4.  The gradients that
were applied are held too, to 1e-4 of the model's largest.  The control
is the per-rank step (one rank's rows alone, no all-reduce): it must
miss those tolerances.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch import config as C
from super_resolution_tpu_torch.data import SyntheticPatches, preprocess_batch
from super_resolution_tpu_torch.data.augment import draw_decisions
from super_resolution_tpu_torch.losses import ragan_discriminator_loss
from super_resolution_tpu_torch.models.discriminator import BatchNorm
from super_resolution_tpu_torch.parallel import dp
from super_resolution_tpu_torch.train.state import init_state
from super_resolution_tpu_torch.train.steps import (
    make_gan_step,
    make_pretrain_step,
)

WORLD = 2
LOSS_ATOL, PARAM_ATOL = 5e-4, 1e-3          # tests/test_dp.py:91-97
PRETRAIN_LOSS_ATOL, PRETRAIN_PARAM_ATOL = 1e-6, 1e-5   # :70-71
SYNC_ATOL = 1e-4                            # :102
GRAD_RTOL = 1e-4
SPAWN_TIMEOUT_S = 120


def dp_cfg(dedup=False):
    return C.TrainConfig(
        generator=C.GeneratorConfig(n_blocks=1, filters=8, growth=4,
                                    init="torch_default"),
        discriminator=C.DiscriminatorConfig(base_filters=8, n_scales=2),
        loss=C.LossConfig(perceptual_source="d_features",
                          lambda_percep=1.0, lambda_pixel=0.1),
        data=C.DataConfig(hr_patch=32, batch_size=4, n_workers=1),
        compute_dtype="float32", dedup_d_hr=dedup, data_parallel=WORLD)


def _batch(cfg, seed, part=(0, 1)):
    return torch.from_numpy(next(iter(SyntheticPatches(cfg.data, seed=seed,
                                                       part=part))))


def _snapshot(state, metrics):
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "g": {k: v.detach().clone() for k, v in state.g.state_dict()
                  .items()},
            "d": {k: v.detach().clone() for k, v in state.d.state_dict()
                  .items()},
            "g_grad": [p.grad.clone() for p in state.g.parameters()],
            "d_grad": [p.grad.clone() if p.grad is not None else None
                       for p in state.d.parameters()]}


def _steps(part):
    """Every scenario of the tests, on this process's rows ``part`` of
    the global batch: one pretrain step, one GAN step of each shape,
    three pretrain steps."""
    out = {}
    cfg = dp_cfg()
    state = init_state(cfg, "cpu")
    out["pretrain"] = _snapshot(state, make_pretrain_step(cfg)(
        state, _batch(cfg, 3, part)))
    for dedup in (False, True):
        cfg = dp_cfg(dedup)
        state = init_state(cfg, "cpu")
        out[f"gan_dedup{dedup}"] = _snapshot(state, make_gan_step(cfg)(
            state, _batch(cfg, 3, part)))
    cfg = dp_cfg()
    state = init_state(cfg, "cpu")
    step = make_pretrain_step(cfg)
    it = iter(SyntheticPatches(cfg.data, seed=4, part=part))
    for _ in range(3):
        metrics = step(state, torch.from_numpy(next(it)))
    out["three_pretrain"] = _snapshot(state, metrics)
    return out


def _helpers(part):
    """BatchNorm and the RaGAN D loss on this rank's rows of fixed
    global inputs: outputs, running statistics, input gradients."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((4, 6, 5, 5))
                         .astype(np.float32))
    pr = torch.from_numpy(rng.standard_normal((4, 2, 2, 1))
                          .astype(np.float32))
    pf = torch.from_numpy(rng.standard_normal((4, 2, 2, 1))
                          .astype(np.float32))
    cot = torch.arange(x.numel()).reshape(x.shape).float().sin()
    index, count = part
    rows = slice(index * 4 // count, (index + 1) * 4 // count)
    x, pr, pf = (t[rows].clone().requires_grad_(True) for t in (x, pr, pf))
    bn = BatchNorm(6, 0.9, 1e-5)
    y = bn(x, train=True)
    # the ranks' sums add up to the single process's sum
    (y * cot[rows]).sum().backward()
    # each rank's loss is a mean over its rows: their sum is `count`
    # times the global mean, and so is its gradient
    loss = ragan_discriminator_loss(pr, pf)
    (loss / count).backward()
    return {"y": y.detach(), "x_grad": x.grad, "running_mean":
            bn.running_mean.clone(), "running_var": bn.running_var.clone(),
            "loss": float(dp.average_metrics({"l": loss.detach()})["l"]),
            "pr_grad": pr.grad, "pf_grad": pf.grad}


def _rank_main(device, out_dir):
    torch.set_num_threads(2)
    part = (dp.rank(), dp.world_size())
    torch.save({"steps": _steps(part), "helpers": _helpers(part),
                "world": dp.world_size()},
               os.path.join(out_dir, f"rank{dp.rank()}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results, and the single process's."""
    out = tmp_path_factory.mktemp("dp")
    dp.launch(_rank_main, (str(out),), ["cpu"] * WORLD,
              init_method=f"file://{out}/store", timeout_s=SPAWN_TIMEOUT_S)
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return got, {"steps": _steps((0, 1)), "helpers": _helpers((0, 1))}


def _close(a, b, atol):
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=atol,
                                   err_msg=k)


def _grads_close(a, b):
    for key in ("g_grad", "d_grad"):
        pairs = [(x, y) for x, y in zip(a[key], b[key]) if y is not None]
        if not pairs:       # D takes no step in a pretrain step
            continue
        scale = max(float(y.abs().max()) for _, y in pairs)
        for x, y in pairs:
            assert float((x - y).abs().max()) <= GRAD_RTOL * scale, key


def test_group_had_two_ranks(ranks):
    got, _ = ranks
    assert [g["world"] for g in got] == [WORLD, WORLD]


def test_pretrain_step_equals_single_process(ranks):
    got, single = ranks
    a, b = got[0]["steps"]["pretrain"], single["steps"]["pretrain"]
    np.testing.assert_allclose(a["metrics"]["loss_pixel"],
                               b["metrics"]["loss_pixel"],
                               atol=PRETRAIN_LOSS_ATOL)
    np.testing.assert_allclose(a["metrics"]["psnr"], b["metrics"]["psnr"],
                               rtol=1e-5)
    _close(a["g"], b["g"], PRETRAIN_PARAM_ATOL)
    _grads_close(a, b)


@pytest.mark.parametrize("dedup", [False, True])
def test_gan_step_equals_single_process(ranks, dedup):
    """RaGAN batch means, D's BatchNorm statistics and the feature-
    matching normaliser global; both step shapes."""
    got, single = ranks
    a = got[0]["steps"][f"gan_dedup{dedup}"]
    b = single["steps"][f"gan_dedup{dedup}"]
    for k in ("loss_g", "loss_d", "loss_adv", "loss_percep", "loss_pixel"):
        np.testing.assert_allclose(a["metrics"][k], b["metrics"][k],
                                   atol=LOSS_ATOL, err_msg=k)
    for k in ("grad_norm_g", "grad_norm_d", "psnr"):
        np.testing.assert_allclose(a["metrics"][k], b["metrics"][k],
                                   rtol=GRAD_RTOL, err_msg=k)
    _close(a["g"], b["g"], PARAM_ATOL)
    _close(a["d"], b["d"], PARAM_ATOL)      # parameters and statistics
    _grads_close(a, b)


def test_ranks_stay_equal_bit_for_bit(ranks):
    """The averaged gradients are the same on every rank, so the ranks'
    parameters, statistics and metrics are too."""
    got, _ = ranks
    for name, a in got[0]["steps"].items():
        b = got[1]["steps"][name]
        assert a["metrics"] == b["metrics"], name
        for tree in ("g", "d"):
            assert all(torch.equal(a[tree][k], b[tree][k]) for k in a[tree])


def test_three_pretrain_steps_stay_in_sync(ranks):
    got, single = ranks
    _close(got[0]["steps"]["three_pretrain"]["g"],
           single["steps"]["three_pretrain"]["g"], SYNC_ATOL)


@pytest.mark.parametrize("dedup", [False, True])
def test_per_rank_control_misses_the_tolerances(ranks, dedup):
    """The per-rank step (rank 0's rows alone, nothing all-reduced: what
    plain data parallelism gives a step whose batch statistics are
    per-rank) is not within the tolerances above of the global step, so
    the comparisons can fail."""
    _, single = ranks
    cfg = dp_cfg(dedup)
    state = init_state(cfg, "cpu")
    local = _snapshot(state, make_gan_step(cfg)(
        state, _batch(cfg, 3, (0, WORLD))))
    ref = single["steps"][f"gan_dedup{dedup}"]
    misses = [k for k in ("loss_g", "loss_d", "loss_adv")
              if abs(local["metrics"][k] - ref["metrics"][k]) > LOSS_ATOL]
    misses += [k for k in ref["d"] if float(
        (local["d"][k] - ref["d"][k]).abs().max()) > PARAM_ATOL]
    assert misses


def test_batchnorm_and_ragan_helpers_equal_the_global_formula(ranks):
    got, single = ranks
    ref = single["helpers"]
    for k in ("y", "x_grad", "pr_grad", "pf_grad"):
        cat = torch.cat([g["helpers"][k] for g in got])
        torch.testing.assert_close(cat, ref[k], atol=1e-6, rtol=1e-5,
                                   msg=k)
    for g in got:
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(g["helpers"][k], ref[k], atol=1e-6,
                                       rtol=1e-5)
        np.testing.assert_allclose(g["helpers"]["loss"], ref["loss"],
                                   rtol=1e-6)


def test_augmentation_decisions_are_the_global_batch_rows():
    """Every rank draws the global batch's decisions from its identically
    seeded generator and keeps its rows: the ranks' pairs concatenate to
    the single process's."""
    cfg = dp_cfg().data
    batch = _batch(dp_cfg(), 5)
    full = preprocess_batch(batch, cfg, torch.Generator().manual_seed(1))
    halves = [preprocess_batch(batch[2 * r:2 * r + 2], cfg,
                               torch.Generator().manual_seed(1),
                               part=(r, 2)) for r in range(2)]
    for k in ("lr", "hr"):
        assert torch.equal(torch.cat([h[k] for h in halves]), full[k])
    d = draw_decisions(torch.Generator().manual_seed(1), 4)
    assert any(bool(x.any()) and not bool(x.all()) for x in d)


def test_no_group_helpers_are_the_identity():
    t = torch.arange(3.0, requires_grad=True)
    assert not dp.active() and dp.world_size() == 1 and dp.rank() == 0
    assert dp.global_mean(t) is t and dp.all_reduce_sum(t) is t
    g = [torch.ones(2), torch.zeros(3)]
    assert all(a is b for a, b in zip(dp.average_gradients(g), g))
    m = {"a": torch.tensor(1.0)}
    assert dp.average_metrics(m) == m


def test_pad_batch_to_mesh():
    b = np.arange(5 * 2).reshape(5, 2)
    padded = dp.pad_batch_to_mesh(b, 8)
    assert padded.shape == (8, 2)
    np.testing.assert_array_equal(padded[5:], np.repeat(b[-1:], 3, axis=0))
    assert dp.pad_batch_to_mesh(b, 5) is b


def test_errors_for_too_few_devices_and_a_batch_that_does_not_divide():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"need {have + 1} devices"):
        dp.devices_for(have + 1, "cuda")
    assert dp.devices_for(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="does not divide"):
        dp.local_rows(5, 2)
    assert dp.local_rows(16, 2) == 8
    with pytest.raises(AssertionError):
        SyntheticPatches(dataclasses.replace(dp_cfg().data, batch_size=5),
                         part=(0, 2))


def test_backend_choice():
    assert dp.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert dp.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert dp.backend_for(["cpu", "cpu"]) == "gloo"
