"""The port's discriminator against the JAX package's, weights and
BatchNorm statistics carried across with
``import_torch.discriminator_state_dict_from_flax``: logits, per-scale
features, and the running statistics after one and two train-mode
forwards.  Inputs are drawn with numpy from a seed.

Tolerance 5e-5 (float32; ``tests/test_parity.py`` holds the JAX
discriminator to its torch spec at the same figure): the two frameworks
sum the convs and the batch statistics in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.config import DiscriminatorConfig as JDConfig
from super_resolution_tpu.models import Discriminator as JDiscriminator
from super_resolution_tpu_torch.config import DiscriminatorConfig
from super_resolution_tpu_torch.import_torch import (
    discriminator_state_dict_from_flax,
)
from super_resolution_tpu_torch.models.discriminator import (
    BatchNorm,
    Discriminator,
)

TOL = dict(atol=5e-5, rtol=5e-5)
KW = dict(base_filters=8, n_scales=3)


def _pair(seed=0):
    """(flax module, variables, port module) with the same weights and
    non-trivial running statistics."""
    jd = JDiscriminator(JDConfig(**KW))
    variables = jd.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)),
                        train=False)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        variables["batch_stats"])
    params = jax.tree.map(
        lambda a: a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                  jnp.float32), variables["params"])
    td = Discriminator(DiscriminatorConfig(**KW))
    td.load_state_dict(discriminator_state_dict_from_flax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)),
        strict=True)
    return jd, {"params": params, "batch_stats": stats}, td


def _x(seed, shape=(4, 32, 32, 3)):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _assert_stats(td, jstats):
    for name, node in jstats.items():
        bn = getattr(td, name)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(node["mean"]), **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(node["var"]), **TOL)


def test_param_count_at_default_width():
    assert sum(p.numel() for p in Discriminator().parameters()) == 4_693_697


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_logits_and_features(train):
    jd, variables, td = _pair()
    x = _x(1)
    if train:
        (jl, jf), _ = jd.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"],
                               return_features=True)
    else:
        jl, jf = jd.apply(variables, jnp.asarray(x), train=False,
                          return_features=True)
    before = {k: v.clone() for k, v in td.batch_stats().items()}
    with torch.no_grad():
        tl, tf = td(torch.from_numpy(x), train=train, return_features=True,
                    update_stats=False)
    assert tl.shape == (4, 4, 4, 1) and len(tf) == 3
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # update_stats=False (and eval mode) leave the running statistics
    for k, v in td.batch_stats().items():
        assert torch.equal(v, before[k])


def test_running_stats_after_one_and_two_forwards():
    """flax updates the running variance with the biased batch variance
    and momentum 0.9 (torch's 0.1); the chained second forward starts
    from the first's statistics."""
    jd, variables, td = _pair(3)
    x1, x2 = _x(4), _x(5)
    _, st1 = jd.apply(variables, jnp.asarray(x1), train=True,
                      mutable=["batch_stats"])
    with torch.no_grad():
        td(torch.from_numpy(x1), train=True)
    _assert_stats(td, st1["batch_stats"])
    _, st2 = jd.apply({"params": variables["params"],
                       "batch_stats": st1["batch_stats"]},
                      jnp.asarray(x2), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        td(torch.from_numpy(x2), train=True)
    _assert_stats(td, st2["batch_stats"])


def test_gradients_match():
    """d(sum of logits^2)/d(params, input) through train-mode BatchNorm."""
    jd, variables, td = _pair(6)
    x = _x(7)

    def loss(params, xin):
        out, _ = jd.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xin,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(out ** 2)

    jg, jgx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                             jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (td(xt, train=True, update_stats=False) ** 2).sum().backward()
    want = discriminator_state_dict_from_flax(jax.tree.map(np.asarray, jg),
                                              {})
    for name, p in td.named_parameters():
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(p.grad.numpy() / scale,
                                   want[name].numpy() / scale, atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-4,
                               rtol=1e-4)


def test_bf16_statistics_are_taken_in_float32():
    """Under bfloat16 compute flax takes the batch statistics in float32
    and returns bfloat16; so does the port."""
    rng = np.random.default_rng(8)
    x = (3.0 + rng.standard_normal((4, 8, 6, 6))).astype(np.float32)
    bn = BatchNorm(8, 0.9, 1e-5)
    y = bn(torch.from_numpy(x).bfloat16(), train=True)
    assert y.dtype == torch.bfloat16
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.1 * xb.mean((0, 2, 3)), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * xb.var((0, 2, 3)), rtol=1e-4)
