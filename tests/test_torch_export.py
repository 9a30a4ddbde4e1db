"""The port's export side against the JAX package's on the CPU:
``import_torch.export_generator`` in the three naming families, the
release shape, the discriminator's sequential naming both ways,
``checkpoint.net_interp``, and ``cli export`` / ``cli interp`` (the JAX
CLI tests' cases: interp round trip, mismatched architectures, the EMA
maturity gate, a warm-started run keeping its EMA, the ``--val_dir``
usage error, the ``--ema`` warning on a ``.pth``, ``--stamp_halo``,
``--no-halo_sweep``).

Weights cross bit for bit (a rename and a transpose); the discriminator
forward is held at 5e-5 (``tests/test_parity.py``'s figure for D),
``net_interp`` at 1e-7.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu import checkpoint as jck
from super_resolution_tpu import halo_sweep as jhs
from super_resolution_tpu import import_torch as jit
from super_resolution_tpu.config import DiscriminatorConfig as JDConfig
from super_resolution_tpu.config import GeneratorConfig as JGConfig
from super_resolution_tpu.models import Discriminator as JDiscriminator
from super_resolution_tpu.models import RRDBNet as JRRDBNet
from super_resolution_tpu_torch.checkpoint import (
    net_interp,
    restore_generator_params,
    restore_generator_trees,
)
from super_resolution_tpu_torch.cli import main
from super_resolution_tpu_torch.config import DiscriminatorConfig
from super_resolution_tpu_torch.import_torch import (
    STYLES,
    export_discriminator,
    export_generator,
    export_generator_release,
    import_discriminator,
    import_generator,
    load_pth,
    save_pth,
    state_dict_from_flax,
)
from super_resolution_tpu_torch.models.discriminator import Discriminator
from super_resolution_tpu_torch.models.rrdb import RRDBNet
from torch_spec import RRDBNetTorch

D_TOL = dict(atol=5e-5, rtol=1e-4)
CPU = ["--device", "cpu", "--dtype", "float32"]
TRAIN = ["--device", "cpu", "--dtype", "float32", "--preset",
         "train_gan_dfm", "--residual_blocks", "1", "--batch_size", "2",
         "--hr_height", "32", "--seed", "3", "--dataset_dir",
         "/nonexistent/synthetic"]


@pytest.fixture(scope="module")
def jax_gen():
    """(flax params, cfg) of a 2-block generator with seeded weights."""
    cfg = JGConfig(n_blocks=2, filters=16, growth=8)
    v = jax.jit(JRRDBNet(cfg).init)(jax.random.key(0),
                                    jnp.zeros((1, 8, 8, 3)))
    return jax.tree.map(np.asarray, v["params"]), cfg


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("style", STYLES)
def test_port_export_imports_into_jax(jax_gen, style):
    params, _ = jax_gen
    sd = state_dict_from_flax(params)
    _, gcfg = import_generator(sd)
    out = export_generator(sd, gcfg, style=style)
    variables, jcfg = jit.import_generator(out)
    assert (jcfg.n_blocks, jcfg.filters, jcfg.growth) == (2, 16, 8)
    _leaves_equal(variables["params"], params)


@pytest.mark.parametrize("style", STYLES)
def test_jax_export_loads_into_the_port_strictly(jax_gen, style):
    params, jcfg = jax_gen
    sd, gcfg = import_generator(jit.export_generator(params, jcfg, style))
    model = RRDBNet(gcfg)
    model.load_state_dict(sd, strict=True)
    want = state_dict_from_flax(params)
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    # and back out in the same family: the JAX export's bytes
    back = export_generator(sd, gcfg, style=style)
    ref = jit.export_generator(params, jcfg, style)
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_release_shape_with_and_without_ema(jax_gen, tmp_path):
    params, _ = jax_gen
    sd = state_dict_from_flax(params)
    _, gcfg = import_generator(sd)
    ema = {k: v * 0.5 for k, v in sd.items()}
    flat = export_generator_release(sd, gcfg)
    assert "conv_first.weight" in flat and "params_ema" not in flat
    rel = export_generator_release(sd, gcfg, ema, style="erik")
    assert set(rel) == {"params", "params_ema"}
    assert "conv1.weight" in rel["params_ema"]
    path = str(tmp_path / "rel.pth")
    save_pth(rel, path)
    # both packages' importers prefer params_ema
    got, _ = import_generator(load_pth(path))
    assert all(torch.equal(got[k], ema[k]) for k in ema)
    jv, _ = jit.import_generator(jit.load_pth(path))
    np.testing.assert_array_equal(
        np.asarray(jv["params"]["conv_first"]["kernel"]),
        0.5 * np.asarray(params["conv_first"]["kernel"]))


def _port_d(seed):
    cfg = DiscriminatorConfig(base_filters=8, n_scales=3)
    d = Discriminator(cfg, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for name, buf in d.named_buffers():
        buf.copy_(torch.rand(buf.shape, generator=g)
                  * (1.0 if name.endswith("var") else 0.6) + 0.5)
    return d, cfg


def _x(seed):
    return np.random.default_rng(seed).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


def test_discriminator_export_imports_into_jax():
    d, cfg = _port_d(0)
    sd = export_discriminator(d.state_dict(), cfg)
    assert sd["model.3.num_batches_tracked"].item() == 0
    variables, jcfg = jit.import_discriminator(sd)
    assert jcfg.n_scales == 3 and jcfg.base_filters == 8
    x = _x(1)
    ref = np.asarray(JDiscriminator(jcfg).apply(
        variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = d(torch.from_numpy(x), train=False).numpy()
    assert got.shape == ref.shape == (2, 4, 4, 1)
    np.testing.assert_allclose(got, ref, **D_TOL)
    # the port's own round trip is exact
    back, bcfg = import_discriminator(sd)
    assert bcfg == cfg
    for k, v in d.state_dict().items():
        assert torch.equal(back[k], v), k


def test_jax_discriminator_export_loads_into_the_port():
    jcfg = JDConfig(base_filters=8, n_scales=3)
    jd = JDiscriminator(jcfg)
    variables = jax.jit(lambda k, x: jd.init(k, x, train=False))(
        jax.random.key(2), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(2)
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree.map(
                     lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape),
                                           jnp.float32),
                     variables["batch_stats"])}
    sd, cfg = import_discriminator(jit.export_discriminator(variables, jcfg))
    d = Discriminator(cfg)
    d.load_state_dict(sd, strict=True)
    x = _x(3)
    ref = np.asarray(jd.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = d(torch.from_numpy(x), train=False).numpy()
    np.testing.assert_allclose(got, ref, **D_TOL)


def test_net_interp_matches_jax(jax_gen):
    params, _ = jax_gen
    sd_a = state_dict_from_flax(params)
    rng = np.random.default_rng(4)
    sd_b = {k: v + torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in sd_a.items()}
    for alpha in (0.0, 0.3, 0.8, 1.0):
        got = net_interp(sd_a, sd_b, alpha)
        ref = jck.net_interp({k: v.numpy() for k, v in sd_a.items()},
                             {k: v.numpy() for k, v in sd_b.items()}, alpha)
        for k in sd_a:
            np.testing.assert_allclose(got[k].numpy(), ref[k], atol=1e-7,
                                       rtol=0)
    assert all(torch.equal(v, sd_a[k])
               for k, v in net_interp(sd_a, sd_b, 0.0).items())
    assert all(torch.equal(v, sd_b[k])
               for k, v in net_interp(sd_a, sd_b, 1.0).items())
    with pytest.raises(ValueError, match="alpha"):
        net_interp(sd_a, sd_b, 1.5)


# ---- the CLI ---------------------------------------------------------


def _spec_pth(path, seed, nf=16, nb=1, gc=8):
    torch.manual_seed(seed)
    torch.save(RRDBNetTorch(nf=nf, nb=nb, gc=gc).state_dict(), path)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 2-step from-scratch run ``pre`` and a 2-step run ``ft``
    warm-started from it (64 / 32 wide: the CLI has no width flag)."""
    root = tmp_path_factory.mktemp("runs")
    pre, ft = str(root / "pre"), str(root / "ft")
    assert main(["train", "--checkpoint_dir", pre, "--steps", "2",
                 "--warmup_batches", "10", *TRAIN]) == 0
    assert main(["train", "--checkpoint_dir", ft, "--steps", "2",
                 "--warmup_batches", "10", "--init_g_from", pre,
                 *TRAIN]) == 0
    return pre, ft


def test_interp_cli_roundtrip(tmp_path):
    a = _spec_pth(tmp_path / "a.pth", 0)
    b = _spec_pth(tmp_path / "b.pth", 1)
    out = str(tmp_path / "blend.pth")
    assert main(["interp", "--psnr_ckpt", a, "--gan_ckpt", b, "--alpha",
                 "0.5", "--out", out, *CPU]) == 0
    va, _ = jit.import_generator(jit.load_pth(a))
    vb, _ = jit.import_generator(jit.load_pth(b))
    vm, _ = jit.import_generator(jit.load_pth(out))
    k = lambda v: np.asarray(v["params"]["conv_first"]["kernel"])  # noqa
    np.testing.assert_allclose(k(vm), 0.5 * (k(va) + k(vb)), atol=1e-6)


def test_interp_cli_train_dir_is_maturity_gated(runs, tmp_path, capsys):
    pre, _ = runs
    other = _spec_pth(tmp_path / "gan.pth", 2, nf=64, gc=32)
    out = str(tmp_path / "blend.pth")
    assert main(["interp", "--psnr_ckpt", pre, "--gan_ckpt", other,
                 "--alpha", "0.25", "--out", out, *CPU]) == 0
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    raw, _ = restore_generator_params(pre, prefer_ema=False)
    pb, _ = import_generator(load_pth(other))
    got, _ = import_generator(load_pth(out))
    torch.testing.assert_close(
        got["conv_first.weight"],
        0.75 * raw["conv_first.weight"] + 0.25 * pb["conv_first.weight"],
        atol=1e-6, rtol=0)


def test_interp_cli_rejects_mismatched_arch(tmp_path):
    a = _spec_pth(tmp_path / "a.pth", 0)
    big = _spec_pth(tmp_path / "big.pth", 0, nb=2)
    with pytest.raises(SystemExit, match="architectures differ"):
        main(["interp", "--psnr_ckpt", a, "--gan_ckpt", big, "--alpha",
              "0.5", "--out", str(tmp_path / "x.pth"), *CPU])


def test_export_cli_ema_gate(runs, tmp_path, capsys):
    """A short from-scratch run exports raw params only (an EMA inside
    its maturity horizon is the run's worst weights); ``--ema`` forces
    ``{params, params_ema}``, whose import gives the EMA tree."""
    pre, _ = runs
    out = str(tmp_path / "release.pth")
    assert main(["export", "--checkpoint", pre, "--out", out,
                 "--no-halo_sweep", *CPU]) == 0
    assert "EMA maturity horizon" in capsys.readouterr().out
    sd = torch.load(out, weights_only=True)
    assert "params_ema" not in sd and "conv_first.weight" in sd
    raw, ema, step = restore_generator_trees(pre)
    assert step == 2 and torch.equal(sd["conv_first.weight"],
                                     raw["conv_first.weight"])
    assert not os.path.exists(out + ".meta.json")

    assert main(["export", "--checkpoint", pre, "--out", out, "--ema",
                 "--no-halo_sweep", "--style", "xinntao_old", *CPU]) == 0
    sd = torch.load(out, weights_only=True)
    assert set(sd) == {"params", "params_ema"}
    assert torch.equal(sd["params_ema"]["model.0.weight"],
                       ema["conv_first.weight"])
    jv, _ = jit.import_generator(jit.load_pth(out))   # prefers params_ema
    np.testing.assert_array_equal(
        np.asarray(jv["params"]["conv_first"]["kernel"]),
        ema["conv_first.weight"].numpy().transpose(2, 3, 1, 0))
    assert not torch.equal(ema["conv_first.weight"], raw["conv_first.weight"])
    assert main(["export", "--checkpoint", pre, "--out", out, "--no-ema",
                 "--no-halo_sweep", *CPU]) == 0
    assert "params_ema" not in torch.load(out, weights_only=True)


def test_export_keeps_ema_for_warm_started_runs(runs, tmp_path, capsys):
    _, ft = runs
    capsys.readouterr()
    out = str(tmp_path / "rel.pth")
    assert main(["export", "--checkpoint", ft, "--out", out,
                 "--no-halo_sweep", *CPU]) == 0
    said = capsys.readouterr().out
    assert "maturity horizon" not in said and "(with params_ema)" in said
    assert set(torch.load(out, weights_only=True)) == {"params",
                                                       "params_ema"}


def test_export_val_dir_requires_a_halo_source(tmp_path, capsys):
    with pytest.raises(SystemExit) as ei:
        main(["export", "--checkpoint", str(tmp_path / "ck"), "--out",
              str(tmp_path / "r.pth"), "--no-halo_sweep", "--val_dir",
              str(tmp_path), *CPU])
    assert ei.value.code == 2
    assert "needs a halo" in capsys.readouterr().err


def test_export_ema_flag_warns_on_pth_input(tmp_path, capsys):
    pth = _spec_pth(tmp_path / "g.pth", 0)
    assert main(["export", "--checkpoint", pth, "--out",
                 str(tmp_path / "r.pth"), "--ema", "--no-halo_sweep",
                 *CPU]) == 0
    assert "no effect on a .pth input" in capsys.readouterr().out


def test_export_stamp_halo_and_no_halo_sweep(tmp_path):
    pth = _spec_pth(tmp_path / "g.pth", 0)
    out = str(tmp_path / "release.pth")
    assert main(["export", "--checkpoint", pth, "--out", out,
                 "--stamp_halo", "4", *CPU]) == 0
    # the JAX package's reader reads the port's sidecar
    assert jhs.read_halo_meta(out) == {"admissible_halo": 4,
                                   "method": "stamped", "scale": 4}
    bare = str(tmp_path / "bare.pth")
    assert main(["export", "--checkpoint", pth, "--out", bare,
                 "--no-halo_sweep", *CPU]) == 0
    assert os.path.exists(bare) and not os.path.exists(bare + ".meta.json")
    # the re-wrapped .pth is the input's weights, bit for bit
    a, _ = import_generator(load_pth(pth))
    b, _ = import_generator(load_pth(bare))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_export_refuses_a_directory_that_is_not_a_train_run(tmp_path):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(SystemExit, match="orbax"):
        main(["export", "--checkpoint", str(tmp_path / "orbax"), "--out",
              str(tmp_path / "r.pth"), "--no-halo_sweep", *CPU])
