""".pth checkpoint loading for the port's generator.

The port's module names are BasicSR's, so importing a checkpoint means
renaming its keys to BasicSR's and inferring the architecture from the
shapes.  Three naming families are recognised (the same as the JAX
package's ``import_torch.py``):

- **BasicSR new-style**: ``conv_first, body.{b}.rdb{k}.conv{j},
  conv_body, conv_up1, conv_up2, conv_hr, conv_last``
- **xinntao old arch-style**: ``model.0, model.1.sub.{b}.RDB{k}.conv{j}.0,
  model.1.sub.{nb} (trunk), model.3, model.6, model.8, model.10``
- **eriklindernoren style**: ``conv1,
  res_blocks.{b}.dense_blocks.{k}.b{j}.0, conv2, upsampling.{0,3},
  conv3.{0,2}`` (LeakyReLU slope 0.01)

:func:`state_dict_from_flax` carries the JAX package's generator tree
across (HWIO → OIHW), :func:`discriminator_state_dict_from_flax` and
:func:`vgg_state_dict_from_flax` the discriminator (with its BatchNorm
statistics) and the VGG trunk, and :func:`adam_state_from_optax` an
optax Adam state, so both packages can compute — and take a training
step — from one set of weights and one optimizer state.  All take numpy
arrays.  Orbax checkpoint directories are the JAX package's format and
are not read here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from super_resolution_tpu_torch.config import GeneratorConfig

STYLES = ("basicsr", "xinntao_old", "erik")


def _tensor(x) -> torch.Tensor:
    """float32 CPU tensor; fp16/bf16 checkpoints (common for released
    EMA weights) load as fp32, the dtype of the model's parameters."""
    t = x.detach().cpu() if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.asarray(x))
    if t.is_floating_point() and t.dtype != torch.float32:
        t = t.float()
    return t


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.pth`` file into a flat name → tensor dict, unwrapping
    BasicSR's ``params_ema`` (preferred), ``params`` or ``state_dict``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("params_ema", "params", "state_dict"):
        if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
            break
    return {k: _tensor(v) for k, v in sd.items()}


def detect_generator_style(keys) -> str:
    ks = set(keys)
    if any(k.startswith("model.1.sub") for k in ks):
        return "xinntao_old"
    if any(k.startswith("body.") for k in ks):
        return "basicsr"
    if any(k.startswith("res_blocks.") for k in ks):
        return "erik"
    raise ValueError(
        "unrecognized generator state dict; expected BasicSR, xinntao-old "
        f"or eriklindernoren naming, got keys like {sorted(ks)[:5]}")


def generator_key_map(style: str, n_blocks: int) -> Dict[str, str]:
    """Conv prefix in ``style`` → BasicSR conv prefix (the port's)."""
    m: Dict[str, str] = {}
    if style == "basicsr":
        for name in ("conv_first", "conv_body", "conv_up1", "conv_up2",
                     "conv_hr", "conv_last"):
            m[name] = name
        for b in range(n_blocks):
            for k in range(1, 4):
                for j in range(1, 6):
                    m[f"body.{b}.rdb{k}.conv{j}"] = f"body.{b}.rdb{k}.conv{j}"
    elif style == "xinntao_old":
        m["model.0"] = "conv_first"
        m[f"model.1.sub.{n_blocks}"] = "conv_body"
        m["model.3"], m["model.6"] = "conv_up1", "conv_up2"
        m["model.8"], m["model.10"] = "conv_hr", "conv_last"
        for b in range(n_blocks):
            for k in range(1, 4):
                for j in range(1, 6):
                    m[f"model.1.sub.{b}.RDB{k}.conv{j}.0"] = \
                        f"body.{b}.rdb{k}.conv{j}"
    elif style == "erik":
        m["conv1"], m["conv2"] = "conv_first", "conv_body"
        m["upsampling.0"], m["upsampling.3"] = "conv_up1", "conv_up2"
        m["conv3.0"], m["conv3.2"] = "conv_hr", "conv_last"
        for b in range(n_blocks):
            for k in range(3):
                for j in range(1, 6):
                    m[f"res_blocks.{b}.dense_blocks.{k}.b{j}.0"] = \
                        f"body.{b}.rdb{k + 1}.conv{j}"
    else:
        raise ValueError(style)
    return m


def infer_generator_cfg(sd: Dict[str, torch.Tensor],
                        style: str) -> GeneratorConfig:
    """Architecture from key names and shapes (n_blocks, filters, growth,
    channels, upsampler; slope 0.01 for the eriklindernoren family)."""
    first_key = {"basicsr": "conv_first.weight", "xinntao_old":
                 "model.0.weight", "erik": "conv1.weight"}[style]
    filters, channels = sd[first_key].shape[0], sd[first_key].shape[1]
    blk = {"basicsr": "body.", "xinntao_old": "model.1.sub.",
           "erik": "res_blocks."}[style]
    idx_pos = len(blk.split(".")) - 1
    block_ids = set()
    for k in sd:
        if k.startswith(blk):
            try:
                block_ids.add(int(k.split(".")[idx_pos]))
            except ValueError:
                pass
    # xinntao-old's model.1.sub.{nb} is the trunk conv, not a block
    n_blocks = max(block_ids) if style == "xinntao_old" \
        else max(block_ids) + 1
    gkey = {"basicsr": "body.0.rdb1.conv1.weight",
            "xinntao_old": "model.1.sub.0.RDB1.conv1.0.weight",
            "erik": "res_blocks.0.dense_blocks.0.b1.0.weight"}[style]
    upkey = {"basicsr": "conv_up1.weight", "xinntao_old": "model.3.weight",
             "erik": "upsampling.0.weight"}[style]
    upsampler = ("pixelshuffle" if sd[upkey].shape[0] == 4 * filters
                 else "nearest_conv")
    return GeneratorConfig(channels=channels, filters=filters,
                           growth=sd[gkey].shape[0], n_blocks=n_blocks,
                           upsampler=upsampler,
                           lrelu_slope=0.01 if style == "erik" else 0.2)


def import_generator(
        state_dict: Dict[str, torch.Tensor],
        cfg: GeneratorConfig | None = None,
        strict: bool = True,
) -> Tuple[Dict[str, torch.Tensor], GeneratorConfig]:
    """A generator state dict of any of the three families → (the port's
    BasicSR-named float32 state dict, inferred cfg).  With ``cfg`` the
    checkpoint must match its structure; ``strict=False`` ignores keys
    that are not model weights (training bookkeeping)."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    style = detect_generator_style(sd)
    inferred = infer_generator_cfg(sd, style)
    if cfg is not None:
        for field in ("filters", "growth", "n_blocks", "upsampler"):
            got, want = getattr(inferred, field), getattr(cfg, field)
            if got != want:
                raise ValueError(
                    f"checkpoint {field}={got} != configured {want}")
        inferred = cfg
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for src, dst in generator_key_map(style, inferred.n_blocks).items():
        for leaf in ("weight", "bias"):
            key = f"{src}.{leaf}"
            if key not in sd:
                raise KeyError(f"missing {key} in checkpoint")
            out[f"{dst}.{leaf}"] = sd[key]
            used.add(key)
    extra = set(sd) - used
    if extra and strict:
        raise ValueError(f"unmapped checkpoint keys: {sorted(extra)[:8]} "
                         "(pass strict=False to ignore)")
    return out, inferred


# the JAX package's generator tree names → BasicSR names
_FLAX_TAIL = {"conv_first": "conv_first", "trunk_conv": "conv_body",
              "upconv1": "conv_up1", "upconv2": "conv_up2",
              "hr_conv": "conv_hr", "conv_last": "conv_last"}


def _vector(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _conv_from_flax(node: dict, name: str,
                    out: Dict[str, torch.Tensor]) -> None:
    """One flax conv node (HWIO kernel, bias) → ``name.weight`` (OIHW) and
    ``name.bias``, float32."""
    out[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(node["kernel"], np.float32)
                             .transpose(3, 2, 0, 1)))
    out[f"{name}.bias"] = _vector(node["bias"])


def state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's generator params (``{"conv_first": {"kernel",
    "bias"}, "block{b}": {"dense{k}": {"conv{j}": …}}, "trunk_conv",
    "upconv1/2", "hr_conv", "conv_last"}``, numpy or jax arrays) → the
    port's state dict, kernels HWIO → OIHW, float32."""
    conv = _conv_from_flax
    sd: Dict[str, torch.Tensor] = {}
    n_blocks = sum(1 for k in params if str(k).startswith("block"))
    for flax_name, name in _FLAX_TAIL.items():
        if flax_name in params:
            conv(params[flax_name], name, sd)
    for b in range(n_blocks):
        blk = params[f"block{b}"]
        for k in range(1, len(blk) + 1):
            dense = blk[f"dense{k}"]
            for j in range(1, len(dense) + 1):
                conv(dense[f"conv{j}"], f"body.{b}.rdb{k}.conv{j}", sd)
    return sd


def discriminator_state_dict_from_flax(params: dict, batch_stats: dict
                                       ) -> Dict[str, torch.Tensor]:
    """The JAX package's discriminator params (``conv{i}_{j}``, ``head``:
    kernel, bias; ``bn{i}_{j}``: scale, bias) and ``batch_stats``
    (``bn{i}_{j}``: mean, var) → the port's ``Discriminator`` state
    dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        if "kernel" in node:
            _conv_from_flax(node, name, sd)
        else:
            sd[f"{name}.weight"] = _vector(node["scale"])
            sd[f"{name}.bias"] = _vector(node["bias"])
    for name, node in batch_stats.items():
        sd[f"{name}.running_mean"] = _vector(node["mean"])
        sd[f"{name}.running_var"] = _vector(node["var"])
    return sd


def vgg_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG trunk params (``conv{i}``: kernel, bias) →
    the port's ``VGGFeatures`` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        _conv_from_flax(node, name, sd)
    return sd


def adam_state_from_optax(opt: torch.optim.Adam,
                          mu: Dict[str, torch.Tensor],
                          nu: Dict[str, torch.Tensor], count: int,
                          names) -> None:
    """Put an optax Adam state into ``opt``: ``mu`` and ``nu`` are the
    first and second moments carried across as state dicts (the
    ``*_from_flax`` functions convert the moment trees like the
    parameters), ``count`` the number of updates done, ``names`` the
    parameter names in the order of the optimizer's parameters."""
    it = iter(names)
    for group in opt.param_groups:
        group["n_updates"] = int(count)
        for p in group["params"]:
            name = next(it)
            opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].to(p.device, p.dtype).clone(),
                "exp_avg_sq": nu[name].to(p.device, p.dtype).clone()}
