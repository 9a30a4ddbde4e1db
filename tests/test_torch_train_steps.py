"""One pretrain step and one GAN step of the port against the JAX
package's, from identical parameters, D statistics and normalised batch,
in float32 on the CPU: every metric, every gradient, D's new running
statistics, the EMA and the updated parameters.

The JAX steps run un-jitted; their ``_prep`` is replaced so both sides
get the same normalised (lr, hr) pair (the port's steps expose
``step.core`` for that), and ``optax.global_norm`` is wrapped to capture
the gradient trees the JAX step applies.

Tolerances (float32; the two frameworks sum convolutions, batch
statistics and means in another order):
- losses and PSNR: rtol 2e-4, atol 1e-6;
- a gradient tensor and the gradient norms: 2e-4 of the tensor's
  largest value (+ rtol 2e-4);
- the bias of a D conv that feeds a BatchNorm has an analytically zero
  gradient (the batch mean removes it), and so has the head's bias under
  the relativistic loss (it shifts real and fake logits alike): both
  packages return only noise there, which is held below 2e-4 of the
  same conv's largest weight gradient and left out of the tight
  parameter check;
- from the second of consecutive steps on, the two packages start from
  parameters up to 2 lr apart (see below), about 1e-3 of a weight, so
  their gradients are held to 5e-2 of the largest and losses to 5e-3;
- D's running statistics: atol = rtol = 5e-5, the discriminator's own
  tolerance;
- updated parameters: one Adam step moves a parameter by about lr times
  sign(gradient) whatever the gradient's size, so where the gradient is
  near zero the two packages may even move it in opposite directions.
  Every parameter must agree within 2 lr per step taken, and those whose
  gradient is above 1 % of its tensor's largest within 0.05 lr;
- the EMA: the parameters' bound times (1 - decay), plus 1e-7.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import super_resolution_tpu.config as JC
import super_resolution_tpu.train.steps as jsteps
from super_resolution_tpu.train.state import init_state as j_init_state
from super_resolution_tpu_torch import config as C
from super_resolution_tpu_torch.import_torch import (
    adam_state_from_optax,
    discriminator_state_dict_from_flax,
    state_dict_from_flax,
    vgg_state_dict_from_flax,
)
from super_resolution_tpu_torch.train.state import (
    init_state,
    lr_schedule,
    n_params,
    set_generator_params,
)
from super_resolution_tpu_torch.train.steps import (
    make_gan_step,
    make_pretrain_step,
)

VGG_ARCH = (8, 8, "M", 16, 16)
LR = 2e-4


def _cfgs(loss=None, **top):
    """The same small config for both packages.  The generator's init is
    ``torch_default``: ``msra_scaled`` (x0.1) gives an almost constant SR
    image, on which BatchNorm's E[x^2] - E[x]^2 cancels catastrophically
    and the two packages' summation orders alone move D's gradients by
    a percent."""
    loss = loss or {}
    out = []
    for M, impl in ((JC, "lax"), (C, "auto")):
        out.append(M.TrainConfig(
            generator=M.GeneratorConfig(filters=16, growth=8, n_blocks=1,
                                        conv_impl=impl,
                                        init="torch_default"),
            discriminator=M.DiscriminatorConfig(base_filters=8, n_scales=2),
            vgg=M.VGGConfig(arch=VGG_ARCH),
            loss=M.LossConfig(**loss),
            data=M.DataConfig(hr_patch=32, batch_size=2),
            compute_dtype="float32", **top))
    return out


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 8, 8, 3)).astype(np.float32),
            rng.standard_normal((2, 32, 32, 3)).astype(np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


SR_GAIN = 30.0


def _j_state(jcfg):
    """The JAX package's initial state with G's last conv scaled up.  A
    freshly drawn G gives an almost constant SR image (deviation 0.02
    around its mean); on such an input the E[x^2] - E[x]^2 of D's
    BatchNorms cancels catastrophically, and the two packages'
    summation orders alone move D's features by 1e-3 and G's gradients
    by a percent.  Scaled, SR varies about as much as HR does."""
    js = j_init_state(jcfg)
    g = {**js.g_params, "conv_last": jax.tree.map(
        lambda a: a * SR_GAIN, js.g_params["conv_last"])}
    return js.replace(g_params=g,
                      g_ema=None if js.g_ema is None else g)


def _carry(jstate, pcfg):
    """A port state holding the JAX state's parameters and statistics."""
    ps = init_state(pcfg, "cpu")
    set_generator_params(ps, state_dict_from_flax(_np(jstate.g_params)))
    ps.d.load_state_dict(discriminator_state_dict_from_flax(
        _np(jstate.d_params), _np(jstate.d_stats)), strict=True)
    if ps.vgg is not None:
        ps.vgg.load_state_dict(vgg_state_dict_from_flax(
            _np(jstate.vgg_params["params"])), strict=True)
    return ps


class _JaxRun:
    """Runs un-jitted JAX steps on given normalised pairs, capturing the
    gradient trees."""

    def __init__(self, monkeypatch):
        self.pair = None
        self.grads = []
        real_norm = optax.global_norm

        def norm(tree):
            self.grads.append(_np(tree))
            return real_norm(tree)

        monkeypatch.setattr(optax, "global_norm", norm)
        monkeypatch.setattr(
            jsteps, "_prep",
            lambda state, batch, cfg: (state.rng, jnp.asarray(self.pair[0]),
                                       jnp.asarray(self.pair[1])))

    def __call__(self, step, state, pair):
        self.pair, self.grads = pair, []
        state, metrics = step(state, None)
        return state, {k: float(v) for k, v in metrics.items()}, self.grads


GRAD_REL, LATER_GRAD_REL = 2e-4, 5e-2
LOSS_RTOL, LATER_LOSS_RTOL = 2e-4, 5e-3


def _assert_metrics(got, want, loss_rtol, norm_rtol):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        rtol = norm_rtol if k.startswith("grad_norm") else loss_rtol
        np.testing.assert_allclose(float(got[k]), v, rtol=rtol, atol=1e-6,
                                   err_msg=k)


def _zero_grad_bias(name, sd):
    """Is ``name`` the bias of a D conv that feeds a BatchNorm, or of
    D's head?"""
    return name == "head.bias" or (
        name.startswith("conv") and name.endswith(".bias")
        and name.replace("conv", "bn").replace(".bias", ".weight") in sd)


def _assert_tree(got_sd, want_sd, rel):
    """Each tensor within ``rel`` of its largest value."""
    assert sorted(got_sd) == sorted(want_sd)
    for name, want in want_sd.items():
        want = want.numpy()
        if _zero_grad_bias(name, want_sd):
            scale = float(want_sd[name.replace(".bias", ".weight")]
                          .abs().max())
            for side in (got_sd[name].detach().numpy(), want):
                assert float(np.abs(side).max()) <= rel * scale, name
            continue
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got_sd[name].detach().numpy() / scale,
                                   want / scale, atol=rel, rtol=rel,
                                   err_msg=name)


def _assert_params(got_sd, want_sd, grads_sd, lr, n_steps=1):
    for name, want in want_sd.items():
        diff = (got_sd[name].detach() - want).abs()
        assert float(diff.max()) <= 2.001 * lr * n_steps, name
        g = grads_sd[name].abs()
        big = g > 1e-2 * g.max()
        if bool(big.any()) and not _zero_grad_bias(name, want_sd):
            assert float(diff[big].max()) <= 0.05 * lr * n_steps, name


def _assert_d_stats(ps, jstats):
    for name, node in jstats.items():
        bn = getattr(ps.d, name)
        for attr, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(bn, attr).numpy(),
                                       np.asarray(node[key]), atol=5e-5,
                                       rtol=5e-5, err_msg=f"{name}.{key}")


def _compare_after(ps, pm, js, jm, jgrads, pcfg, n_steps=1, d_lr=LR,
                   grad_rel=GRAD_REL, loss_rtol=LOSS_RTOL):
    _assert_metrics(pm, jm, loss_rtol, grad_rel)
    g_grads = state_dict_from_flax(jgrads[0])
    _assert_tree({k: p.grad for k, p in ps.g.named_parameters()}, g_grads,
                 grad_rel)
    g_want = state_dict_from_flax(_np(js.g_params))
    _assert_params(dict(ps.g.named_parameters()), g_want, g_grads, LR,
                   n_steps)
    ema_want = state_dict_from_flax(_np(js.g_ema))
    bound = 2.001 * LR * n_steps * (1 - pcfg.ema_decay) + 1e-7
    for name, want in ema_want.items():
        assert float((ps.g_ema[name] - want).abs().max()) <= bound, name
        assert not torch.equal(ps.g_ema[name],
                               dict(ps.g.named_parameters())[name])
    assert ps.step == int(js.step)
    if len(jgrads) > 1:
        d_grads = discriminator_state_dict_from_flax(jgrads[1], {})
        _assert_tree({k: p.grad for k, p in ps.d.named_parameters()},
                     d_grads, grad_rel)
        d_want = discriminator_state_dict_from_flax(_np(js.d_params), {})
        _assert_params(dict(ps.d.named_parameters()), d_want, d_grads,
                       d_lr, n_steps)
        _assert_d_stats(ps, js.d_stats)


def test_pretrain_step(monkeypatch):
    jcfg, pcfg = _cfgs(loss=dict(use_perceptual=False))
    run = _JaxRun(monkeypatch)
    js = _j_state(jcfg)
    ps = _carry(js, pcfg)
    pair = _batch(0)
    js, jm, jgrads = run(jsteps.make_pretrain_step(jcfg, jit=False), js,
                         pair)
    pm = make_pretrain_step(pcfg).core(ps, *map(torch.from_numpy, pair))
    assert sorted(pm) == ["grad_norm_g", "loss_pixel", "psnr"]
    _compare_after(ps, pm, js, jm, jgrads, pcfg)


VARIANTS = {
    "default": dict(loss=dict(use_perceptual=False)),
    "dedup_d_hr": dict(loss=dict(use_perceptual=False), dedup_d_hr=True),
    "bn_track_g_step": dict(loss=dict(use_perceptual=False),
                            bn_track_g_step=True),
    "ragan_g_two_sided": dict(loss=dict(use_perceptual=False,
                                        ragan_g_two_sided=True)),
    "d_features": dict(loss=dict(perceptual_source="d_features",
                                 lambda_pixel=0.1),
                       optim_d=dict(lr=3e-5)),
    "d_features_dedup": dict(loss=dict(perceptual_source="d_features",
                                       lambda_pixel=0.1), dedup_d_hr=True),
    "random_vgg": dict(loss=dict(perceptual_source="vgg")),
}


def _variant_cfgs(name):
    kw = dict(VARIANTS[name])
    d_lr = LR
    if "optim_d" in kw:
        d_lr = kw["optim_d"]["lr"]
    jcfg, pcfg = _cfgs(**{k: v for k, v in kw.items() if k != "optim_d"})
    if "optim_d" in kw:
        jcfg = dataclasses.replace(jcfg, optim_d=JC.OptimConfig(lr=d_lr))
        pcfg = dataclasses.replace(pcfg, optim_d=C.OptimConfig(lr=d_lr))
    return jcfg, pcfg, d_lr


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_gan_step(name, monkeypatch):
    jcfg, pcfg, d_lr = _variant_cfgs(name)
    run = _JaxRun(monkeypatch)
    js = _j_state(jcfg)
    ps = _carry(js, pcfg)
    pair = _batch(1)
    js, jm, jgrads = run(jsteps.make_gan_step(jcfg, jit=False), js, pair)
    pm = make_gan_step(pcfg).core(ps, *map(torch.from_numpy, pair))
    want_names = {"loss_pixel", "loss_adv", "loss_g", "loss_d", "psnr",
                  "grad_norm_g", "grad_norm_d"}
    if pcfg.loss.use_perceptual:
        want_names.add("loss_percep")
    assert set(pm) == want_names
    _compare_after(ps, pm, js, jm, jgrads, pcfg, d_lr=d_lr)


def test_two_consecutive_gan_steps(monkeypatch):
    """Warmup step, then two GAN steps with d_features: the second and
    third start from each package's own Adam state and D statistics."""
    jcfg, pcfg, d_lr = _variant_cfgs("d_features")
    run = _JaxRun(monkeypatch)
    js = _j_state(jcfg)
    ps = _carry(js, pcfg)
    jpre, jgan = (jsteps.make_pretrain_step(jcfg, jit=False),
                  jsteps.make_gan_step(jcfg, jit=False))
    ppre, pgan = make_pretrain_step(pcfg), make_gan_step(pcfg)
    for i, (jstep, pstep) in enumerate(((jpre, ppre), (jgan, pgan),
                                        (jgan, pgan))):
        # seed 10 puts one pre-activation of conv_hr at 1e-8, within
        # float32 noise of LeakyReLU's kink: the packages then take
        # different branches there and the first step's gradients part
        # by 2e-3
        pair = _batch(11 + i)
        js, jm, jgrads = run(jstep, js, pair)
        pm = pstep.core(ps, *map(torch.from_numpy, pair))
        later = i > 0
        _compare_after(ps, pm, js, jm, jgrads, pcfg, n_steps=i + 1,
                       d_lr=d_lr,
                       grad_rel=LATER_GRAD_REL if later else GRAD_REL,
                       loss_rtol=LATER_LOSS_RTOL if later else LOSS_RTOL)
    assert ps.step == 3
    assert ps.g_opt.param_groups[0]["n_updates"] == 3
    assert ps.d_opt.param_groups[0]["n_updates"] == 2


def test_step_from_carried_adam_state(monkeypatch):
    """A GAN step from a non-trivial optimizer state carried across with
    ``adam_state_from_optax``: with second moments in place one update
    no longer jumps by lr·sign(g), so the parameters of both packages
    agree within 0.05 lr wherever this step's gradient is above 1 % of
    its tensor's largest (2 lr everywhere), from one state."""
    jcfg, pcfg, _ = _variant_cfgs("default")
    run = _JaxRun(monkeypatch)
    js = _j_state(jcfg)
    jgan = jsteps.make_gan_step(jcfg, jit=False)
    js, _, _ = run(jgan, js, _batch(20))
    js, _, _ = run(jgan, js, _batch(21))
    ps = _carry(js, pcfg)
    ps.step = int(js.step)
    for opt, jopt, conv, module in (
            (ps.g_opt, js.g_opt, state_dict_from_flax, ps.g),
            (ps.d_opt, js.d_opt,
             lambda t: discriminator_state_dict_from_flax(t, {}), ps.d)):
        adam = jopt[0]
        adam_state_from_optax(opt, conv(_np(adam.mu)), conv(_np(adam.nu)),
                              int(adam.count),
                              [n for n, _ in module.named_parameters()])
        assert opt.param_groups[0]["n_updates"] == 2
    ema0 = state_dict_from_flax(_np(js.g_ema))
    ps.g_ema = {k: v.clone() for k, v in ema0.items()}
    pair = _batch(22)
    js, jm, jgrads = run(jgan, js, pair)
    pm = make_gan_step(pcfg).core(ps, *map(torch.from_numpy, pair))
    _compare_after(ps, pm, js, jm, jgrads, pcfg)


def test_lr_schedule_boundaries():
    """The halved rate first applies to the update whose count equals the
    listed step, as optax.piecewise_constant_schedule has it."""
    ocfg = C.OptimConfig(lr=1e-3, lr_halve_steps=(3, 5))
    want = optax.piecewise_constant_schedule(1e-3, {3: 0.5, 5: 0.5})
    sched = lr_schedule(ocfg)
    for count in range(8):
        assert sched(count) == pytest.approx(float(want(count)), rel=1e-6)
    assert [sched(c) for c in (2, 3, 4, 5)] == [1e-3, 5e-4, 5e-4, 2.5e-4]
    assert lr_schedule(C.OptimConfig(lr=1e-3))(10 ** 6) == 1e-3


def test_lr_schedule_in_a_step():
    """Three pretrain steps with a boundary at 2: the optimizer's rate at
    each update."""
    _, pcfg = _cfgs(loss=dict(use_perceptual=False))
    pcfg = dataclasses.replace(
        pcfg, optim_g=C.OptimConfig(lr=1e-3, lr_halve_steps=(2,)))
    ps = init_state(pcfg, "cpu")
    step = make_pretrain_step(pcfg)
    rates = []
    for i in range(3):
        step.core(ps, *map(torch.from_numpy, _batch(30 + i)))
        rates.append(ps.g_opt.param_groups[0]["lr"])
    assert rates == [1e-3, 1e-3, 5e-4]


def test_presets_equal_the_jax_package():
    for name in ("infer_single", "pretrain_psnr", "train_gan",
                 "train_gan_dfm", "infer_tiled", "train_gan_dp8"):
        assert dataclasses.asdict(C.preset(name)) == \
            dataclasses.asdict(JC.preset(name)), name
    assert C.PRESETS == JC.PRESETS
    assert C.ema_maturity_steps(0.999) == JC.ema_maturity_steps(0.999)
    assert C.preset("train_gan_dp8").data_parallel == 8


def test_n_params_matches_the_jax_package():
    from super_resolution_tpu.train.state import n_params as j_n_params

    jcfg, pcfg = _cfgs(loss=dict(use_perceptual=False))
    js, ps = j_init_state(jcfg), init_state(pcfg, "cpu")
    assert n_params(ps.g) == j_n_params(js.g_params)
    assert n_params(ps.d) == j_n_params(js.d_params)
    assert n_params(ps.g_ema) == n_params(ps.g)

