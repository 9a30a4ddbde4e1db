"""Every loss of the port (``super_resolution_tpu_torch.losses``) and its
gradient with respect to the logits / features / images, against the JAX
package's ``losses.py`` on the same numpy inputs.

Tolerance 1e-6 absolute, 1e-5 relative (float32): the same formulas,
with means summed in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import super_resolution_tpu.losses as J
import super_resolution_tpu_torch.losses as T

TOL = dict(atol=1e-6, rtol=1e-5)


def _arr(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _both(name, args, wrt):
    """(value, grads wrt the listed argument indices) from both sides."""
    jf, tf = getattr(J, name), getattr(T, name)
    jargs = [jnp.asarray(a) for a in args]
    jv, jg = jax.value_and_grad(lambda *a: jf(*a), argnums=wrt)(*jargs)
    targs = [torch.from_numpy(a).requires_grad_(i in wrt)
             for i, a in enumerate(args)]
    tv = tf(*targs)
    tg = torch.autograd.grad(tv, [targs[i] for i in wrt], allow_unused=True)
    return (float(jv), [np.asarray(g) for g in jg]), \
        (float(tv.detach()), [np.zeros_like(args[i]) if g is None else g.numpy()
                     for i, g in zip(wrt, tg)])


@pytest.mark.parametrize("name,wrt", [
    ("l1_loss", (0, 1)),
    ("psnr", (0,)),
    ("ragan_generator_loss", (0, 1)),
    ("ragan_generator_loss_two_sided", (0, 1)),
    ("ragan_discriminator_loss", (0, 1)),
])
def test_loss_and_gradient(name, wrt):
    shape = (4, 3, 3, 1) if "ragan" in name else (2, 8, 8, 3)
    args = [_arr(1, shape, 2.0), _arr(2, shape, 2.0)]
    (jv, jg), (tv, tg) = _both(name, args, wrt)
    np.testing.assert_allclose(tv, jv, **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **TOL)
    if name == "ragan_generator_loss":
        assert not tg[0].any()       # the real logits are detached


def test_feature_matching_loss_and_gradient():
    fp = [_arr(3, (2, 8, 8, 4)), _arr(4, (2, 4, 4, 8))]
    ft = [_arr(5, (2, 8, 8, 4)), _arr(6, (2, 4, 4, 8))]
    jv, jg = jax.value_and_grad(
        lambda a, b: J.feature_matching_loss(a, b), argnums=(0, 1))(
        [jnp.asarray(a) for a in fp], [jnp.asarray(a) for a in ft])
    tp = [torch.from_numpy(a).requires_grad_(True) for a in fp]
    tt = [torch.from_numpy(a).requires_grad_(True) for a in ft]
    tv = T.feature_matching_loss(tp, tt)
    tg = torch.autograd.grad(tv, tp + tt, allow_unused=True)
    np.testing.assert_allclose(float(tv.detach()), float(jv), **TOL)
    for a, b in zip(tg[:2], jg[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert all(g is None for g in tg[2:])      # targets are detached
    assert not any(np.asarray(g).any() for g in jg[1])


def test_perceptual_loss_and_gradient():
    """With a stand-in feature extractor (one fixed linear map)."""
    w = _arr(7, (3, 5))
    pred, target = _arr(8, (2, 4, 4, 3)), _arr(9, (2, 4, 4, 3))
    jv, jg = jax.value_and_grad(
        lambda p, t: J.perceptual_loss(lambda prm, x: x @ prm,
                                       jnp.asarray(w), p, t),
        argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(target))
    tp = torch.from_numpy(pred).requires_grad_(True)
    tt = torch.from_numpy(target).requires_grad_(True)
    tv = T.perceptual_loss(lambda x: x @ torch.from_numpy(w), tp, tt)
    (gp, gt) = torch.autograd.grad(tv, [tp, tt], allow_unused=True)
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jg[0]), **TOL)
    assert gt is None and not np.asarray(jg[1]).any()


def test_bce_is_stable_at_large_logits():
    big = np.array([[-80.0], [80.0]], np.float32).reshape(2, 1, 1, 1)
    zero = np.zeros_like(big)
    for name in ("ragan_generator_loss", "ragan_discriminator_loss"):
        tv = getattr(T, name)(torch.from_numpy(big), torch.from_numpy(zero))
        jv = getattr(J, name)(jnp.asarray(big), jnp.asarray(zero))
        assert np.isfinite(float(tv))
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
