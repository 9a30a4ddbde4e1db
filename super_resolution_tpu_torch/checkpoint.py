"""Checkpoint and resume (the JAX package's ``checkpoint.py``, with
``torch.save`` in place of orbax).

A checkpoint directory holds one sub-directory per saved step,
``<step>/state.pt`` (the whole train state: G and D parameters, both Adam
states, D's BatchNorm statistics, the EMA, the step and both random
generators) and ``<step>/data.json`` (the loader's state), so a resume is
step-exact.  The newest five steps are kept.  Orbax directories are the
JAX package's format and are not read here; torch ``.pth`` files import
through :mod:`super_resolution_tpu_torch.import_torch`.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import torch

from super_resolution_tpu_torch.config import ema_maturity_steps

if TYPE_CHECKING:   # train/loop.py imports this module
    from super_resolution_tpu_torch.train.state import GANTrainState

STATE_FILE, DATA_FILE = "state.pt", "data.json"


def _steps(ckpt_dir: str) -> List[int]:
    """Saved steps under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit()
                  and os.path.isfile(os.path.join(ckpt_dir, n, STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, state: GANTrainState,
                    data_state: Optional[dict] = None,
                    max_to_keep: int = 5) -> int:
    from super_resolution_tpu_torch.train.state import state_dict

    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    step = state.step
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state_dict(state), os.path.join(tmp, STATE_FILE))
    if data_state is not None:
        with open(os.path.join(tmp, DATA_FILE), "w") as f:
            json.dump(data_state, f)
    dst = os.path.join(ckpt_dir, str(step))
    shutil.rmtree(dst, ignore_errors=True)
    os.replace(tmp, dst)         # a reader never sees a partial step
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)
    return step


def _load_tree(ckpt_dir: str, step: Optional[int]) -> Tuple[dict, int]:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    tree = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE),
                      map_location="cpu", weights_only=True)
    return tree, step


def restore_checkpoint(ckpt_dir: str, template: GANTrainState,
                       step: Optional[int] = None,
                       ) -> Tuple[GANTrainState, Optional[dict], int]:
    """Restore (state, data_state, step) into ``template``, a state built
    with ``init_state`` on the same config (it is filled in place)."""
    from super_resolution_tpu_torch.train.state import load_state_dict

    tree, step = _load_tree(ckpt_dir, step)
    load_state_dict(template, tree)
    data_path = os.path.join(ckpt_dir, str(step), DATA_FILE)
    data_state = None
    if os.path.isfile(data_path):
        with open(data_path) as f:
            data_state = json.load(f)
    return template, data_state, step


def ema_provenance_path(ckpt_dir: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), "ema_provenance.json")


def write_ema_provenance(ckpt_dir: str, meta: dict) -> str:
    """Record how the run's EMA was seeded, next to the step
    directories.  A warm-started run seeds the EMA from the warm-start
    weights, not from a random init, so its EMA can be trusted from step
    0 and the step-count maturity gate must not strip it."""
    os.makedirs(os.path.abspath(ckpt_dir), exist_ok=True)
    path = ema_provenance_path(ckpt_dir)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
        f.write("\n")
    return path


def read_ema_provenance(ckpt_dir: str) -> Optional[dict]:
    path = ema_provenance_path(ckpt_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def restore_generator_trees(ckpt_dir: str, step: Optional[int] = None):
    """``(g_params, g_ema or None, step)`` of a train-state checkpoint, as
    CPU state dicts, without building a state."""
    tree, step = _load_tree(ckpt_dir, step)
    return tree["g"], tree.get("g_ema"), step


def restore_generator_params(ckpt_dir: str, step: Optional[int] = None,
                             prefer_ema: bool = True,
                             ema_decay: Optional[float] = None,
                             ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Just the generator's state dict from a train-state checkpoint (the
    inference path).  ``prefer_ema`` returns the EMA when the checkpoint
    has one.  With ``ema_decay`` that preference is maturity-gated: a
    checkpoint saved before ``ema_maturity_steps(ema_decay)`` steps gives
    the raw parameters with a warning, unless ``ema_provenance.json``
    next to the steps says the EMA was seeded by a warm start."""
    g_params, g_ema, step = restore_generator_trees(ckpt_dir, step)
    if prefer_ema and g_ema is not None:
        if ema_decay is not None:
            need = ema_maturity_steps(ema_decay)
            prov = read_ema_provenance(ckpt_dir)
            if prov is not None and prov.get("warm_start"):
                return g_ema, step
            if step < need:
                print(f"[checkpoint] step-{step} checkpoint is inside "
                      f"the EMA maturity horizon ({need} steps at decay "
                      f"{ema_decay}) and carries no warm-start "
                      f"provenance — using raw params instead of the "
                      f"immature EMA (pass prefer_ema without ema_decay "
                      f"to force the EMA tree)")
                return g_params, step
        return g_ema, step
    return g_params, step


def net_interp(params_psnr: Dict[str, torch.Tensor],
               params_gan: Dict[str, torch.Tensor],
               alpha: float) -> Dict[str, torch.Tensor]:
    """ESRGAN network interpolation (paper §3.4): θ = α·θ_GAN +
    (1−α)·θ_PSNR, tensor by tensor over two state dicts with the same
    keys."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0,1], got {alpha}")
    if set(params_psnr) != set(params_gan):
        raise ValueError("net_interp: the state dicts have other keys: "
                         f"{sorted(set(params_psnr) ^ set(params_gan))[:8]}")
    return {k: (1.0 - alpha) * v + alpha * params_gan[k]
            for k, v in params_psnr.items()}
