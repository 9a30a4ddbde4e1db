"""The grain-backed patch loader (the JAX package's
``data/grain_source.py``): ``cli train --loader grain``.

The default :class:`~super_resolution_tpu_torch.data.pipeline.PatchLoader`
is a threaded loader with explicit resume state.  This one gives the same
``__iter__`` / ``state_dict`` / ``load_state_dict`` surface on
``grain.MapDataset`` (grain's multiprocess prefetch and checkpointable
iterators), so ``train()`` takes either:

    source (image paths, or (HR, LR) path pairs when ``cfg.lr_dir`` is
    set) -> shuffle(seed) -> repeat -> map_with_index (the record's seed
    is (seed, index)) -> map(decode and crop) -> batch

The batches are the JAX loader's bytes: the same chain of grain
datasets over the same decode and crop functions.  ``part=(index,
count)`` decodes only this rank's rows of each global batch (under data
parallelism a part is a rank, where the JAX package's part is a host);
the concatenation over the parts is the ``part=(0, 1)`` stream.  The
resume state is grain's own iterator state, a JSON tree, which goes into
the checkpoint's ``data.json``.

``grain`` is imported when a loader is built, never with this module, so
the port imports without it; without it the loader raises, and nothing
falls back to the threaded loader.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from super_resolution_tpu_torch.config import DataConfig
from super_resolution_tpu_torch.data.pipeline import (
    _decode_crop,
    _decode_crop_pair,
    list_images,
    pair_images,
)


def import_grain():
    """The ``grain`` module, or an ImportError that names the package."""
    try:
        import grain
    except ImportError as e:
        raise ImportError(
            "--loader grain needs the 'grain' package, which this Python "
            "does not have (ROADMAP.md: the card's machine has none); "
            "install grain or use --loader threads") from e
    return grain


class GrainPatchLoader:
    """grain.MapDataset-based uint8 HR patch batches (B, P, P, 3), or
    paired ``{"hr", "lr"}`` dict batches when ``cfg.lr_dir`` is set."""

    def __init__(self, cfg: DataConfig, files: Optional[Sequence[str]] = None,
                 seed: int = 0, part: Tuple[int, int] = (0, 1)):
        grain = import_grain()

        self.cfg = cfg
        index, count = int(part[0]), int(part[1])
        if not 0 <= index < count or cfg.batch_size % count:
            raise ValueError(f"part {part} does not split a global batch "
                             f"of {cfg.batch_size}")
        self.part = (index, count)
        self.paired = cfg.lr_dir is not None
        if self.paired:
            # (hr_path, lr_path) tuples matched by stem, as PatchLoader's
            self.files = list(files) if files is not None \
                else pair_images(cfg.dataset_dir, cfg.lr_dir)
        else:
            self.files = list(files) if files is not None \
                else list_images(cfg.dataset_dir)
        self.seed = seed

        patch = cfg.patch_hw
        scale = cfg.scale
        paired = self.paired

        def decode(path_and_seed):
            path, record_seed = path_and_seed
            rng = np.random.default_rng(record_seed)
            if paired:
                hr, lr = _decode_crop_pair(path[0], path[1], patch, scale,
                                           rng)
                return {"hr": hr, "lr": lr}
            return _decode_crop(path, patch, rng)

        base = (grain.MapDataset.source(list(self.files))
                .shuffle(seed=seed)
                .repeat()
                .map_with_index(lambda i, p: (p, (seed, i)))
                .map(decode))
        if count > 1:
            # global batch s row r is record s·B + r, so this part's rows
            # are the strided slices lo+j::B, mixed round-robin back into
            # step order: each part decodes only its rows
            b_glob = cfg.batch_size
            local = b_glob // count
            lo = index * local
            base = grain.MapDataset.mix(
                [base[lo + j::b_glob] for j in range(local)])
            ds = base.batch(local)
        else:
            ds = base.batch(cfg.batch_size)
        it = ds.to_iter_dataset()
        if cfg.n_workers > 0:
            it = it.mp_prefetch(grain.multiprocessing.MultiprocessingOptions(
                num_workers=cfg.n_workers))
        self._ds = it
        self._iter = None

    def _ensure_iter(self):
        if self._iter is None:
            self._iter = iter(self._ds)
        return self._iter

    def __iter__(self):
        it = self._ensure_iter()
        while True:
            batch = next(it)
            if isinstance(batch, dict):
                yield {k: np.asarray(v) for k, v in batch.items()}
            else:
                yield np.asarray(batch)

    # resume: grain's native iterator state
    def state_dict(self) -> dict:
        return {"grain_state": self._ensure_iter().get_state(),
                "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self._ensure_iter().set_state(state["grain_state"])
