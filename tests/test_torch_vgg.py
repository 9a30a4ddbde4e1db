"""The port's VGG-19 trunk against the JAX package's with seeded random
weights carried across (``import_torch.vgg_state_dict_from_flax``), and
``load_vgg_params`` on the npz format of ``tools/convert_vgg.py``.

Tolerance 1e-4 of the features' largest value (float32, 16 convs; the
figure ``tests/test_parity.py`` uses for the JAX trunk against its torch
spec): the frameworks sum the convs in another order.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.config import VGGConfig as JVGGConfig
from super_resolution_tpu.models import VGGFeatures as JVGG
from super_resolution_tpu.models import load_vgg_params as j_load
from super_resolution_tpu_torch.config import VGGConfig
from super_resolution_tpu_torch.import_torch import vgg_state_dict_from_flax
from super_resolution_tpu_torch.models.vgg import VGGFeatures, load_vgg_params

ARCH = (8, 8, "M", 16, 16, "M", 16, 16)


def _close(a, b):
    scale = float(np.abs(b).max())
    np.testing.assert_allclose(a / scale, b / scale, atol=1e-4, rtol=1e-4)


def _flax(seed, arch):
    jv = JVGG(JVGGConfig(arch=arch))
    return jv, jv.init(jax.random.key(seed), jnp.zeros((1, 16, 16, 3)))


def test_features_match_small_arch():
    jv, variables = _flax(0, ARCH)
    tv = VGGFeatures(VGGConfig(arch=ARCH))
    tv.load_state_dict(vgg_state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"])), strict=True)
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 3)) \
        .astype(np.float32)
    want = np.asarray(jv.apply(variables, jnp.asarray(x)))
    got = tv(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 4, 4, 16)
    _close(got.numpy(), want)
    assert (got.numpy() < 0).any()      # conv5_4 stays pre-activation


def test_full_trunk_and_npz_loading(tmp_path):
    """The VGG-19 arch at full depth on a 32x32 input, weights through
    the npz file both packages read."""
    arch = JVGGConfig().arch
    assert arch == VGGConfig().arch
    jv, variables = _flax(2, arch)
    npz = {}
    for name, node in variables["params"].items():
        npz[f"{name}_kernel"] = np.asarray(node["kernel"])
        npz[f"{name}_bias"] = np.asarray(node["bias"])
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **npz)
    tv = VGGFeatures()
    tv.load_state_dict(load_vgg_params(path), strict=True)
    assert not any(p.requires_grad for p in tv.parameters())
    assert sum(p.numel() for p in tv.parameters()) == 20_024_384
    x = np.random.default_rng(3).standard_normal((1, 32, 32, 3)) \
        .astype(np.float32)
    want = np.asarray(jv.apply(j_load(path), jnp.asarray(x)))
    got = tv(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 2, 2, 512)
    _close(got, want)


def test_gradient_reaches_the_input_only():
    tv = VGGFeatures(VGGConfig(arch=ARCH))
    x = torch.randn(1, 8, 8, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    tv(x).abs().sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
    assert all(p.grad is None for p in tv.parameters())
