"""Host-side image loader: decode -> random-crop -> batch -> device
prefetch (the JAX package's ``data/pipeline.py``).  Decode threads feed a
reorder buffer, and :func:`device_prefetch` moves batches to the device
through pinned memory with non-blocking copies.  Batches are uint8 HR
patches; all arithmetic happens on the device (data/augment.py).

:class:`SyntheticPatches` gives deterministic random patches, so training
and smoke runs need no dataset on disk; it is numpy only, and the same
seed gives the same bytes as the JAX package's.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from super_resolution_tpu_torch.config import DataConfig

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def list_images(root: str) -> List[str]:
    """Every image under ``root`` (recursive), sorted; raises when none."""
    files = []
    for dirpath, _, names in os.walk(root):
        for n in sorted(names):
            if n.lower().endswith(IMAGE_EXTS):
                files.append(os.path.join(dirpath, n))
    if not files:
        raise FileNotFoundError(f"no images under {root!r}")
    return sorted(files)


def pair_images(hr_dir: str, lr_dir: str) -> List[Tuple[str, str]]:
    """Match HR and LR files by stem (extension-agnostic) (the paired
    dataset mode).  Every HR file
    must have an LR partner; extras in ``lr_dir`` are ignored."""
    def by_stem(root):
        out = {}
        for p in list_images(root):
            stem = os.path.splitext(os.path.basename(p))[0]
            out.setdefault(stem, p)
        return out

    hr, lr = by_stem(hr_dir), by_stem(lr_dir)
    missing = sorted(set(hr) - set(lr))
    if missing:
        raise FileNotFoundError(
            f"no LR partner in {lr_dir!r} for HR stems {missing[:5]}"
            + ("…" if len(missing) > 5 else ""))
    return [(hr[s], lr[s]) for s in sorted(hr)]


def _decode(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _decode_crop_pair(hr_path: str, lr_path: str, patch: Tuple[int, int],
                      scale: int, rng: np.random.Generator):
    """Aligned random crop from a paired (HR, LR) frame: the LR crop is
    ``patch//scale`` at (top/scale, left/scale) — positions are drawn on
    the LR grid so the two crops cover exactly the same field of view."""
    hr = _decode(hr_path)
    lr = _decode(lr_path)
    lp_h, lp_w = patch[0] // scale, patch[1] // scale
    eh, ew = lr.shape[0] * scale, lr.shape[1] * scale
    if hr.shape[0] != eh or hr.shape[1] != ew:
        raise ValueError(
            f"paired size mismatch: HR {hr.shape[:2]} vs LR "
            f"{lr.shape[:2]}×{scale} for {os.path.basename(hr_path)}")
    if lr.shape[0] < lp_h or lr.shape[1] < lp_w:
        pad_y = max(0, lp_h - lr.shape[0])
        pad_x = max(0, lp_w - lr.shape[1])
        lr = np.pad(lr, ((0, pad_y), (0, pad_x), (0, 0)), mode="reflect")
        hr = np.pad(hr, ((0, pad_y * scale), (0, pad_x * scale), (0, 0)),
                    mode="reflect")
    top = int(rng.integers(0, lr.shape[0] - lp_h + 1))
    left = int(rng.integers(0, lr.shape[1] - lp_w + 1))
    return (hr[top * scale:(top + lp_h) * scale,
               left * scale:(left + lp_w) * scale],
            lr[top:top + lp_h, left:left + lp_w])


def _decode_crop(path: str, patch: Tuple[int, int],
                 rng: np.random.Generator) -> np.ndarray:
    """PIL decode + random HR crop → (patch_h, patch_w, 3) uint8.  Images
    smaller than the patch are reflect-padded (a fallback for test
    data)."""
    from PIL import Image

    p_h, p_w = patch
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    h, w = arr.shape[:2]
    if h < p_h or w < p_w:
        arr = np.pad(arr, ((0, max(0, p_h - h)), (0, max(0, p_w - w)),
                           (0, 0)), mode="reflect")
        h, w = arr.shape[:2]
    top = int(rng.integers(0, h - p_h + 1))
    left = int(rng.integers(0, w - p_w + 1))
    return arr[top:top + p_h, left:left + p_w]


class PatchLoader:
    """Infinite iterator of uint8 HR patch batches (B, P, P, 3).

    Batch ``k`` is a pure function of ``(seed, k)``, so the stream is
    deterministic regardless of worker count: with ``cfg.n_workers > 1``,
    decode threads *claim* step indices and a reorder buffer yields
    strictly in step order — identical batches, identical order, to the
    single-worker path.  :meth:`state_dict` therefore captures exact
    resume state (the next step to yield) even at the default of 4
    workers.  ``part=(index, count)`` yields rows
    [index·B/count, (index+1)·B/count) of the global batch: rank
    ``index`` of ``count`` under data parallelism.
    """

    def __init__(self, cfg: DataConfig, files: Optional[Sequence[str]] = None,
                 seed: int = 0,
                 part: Tuple[int, int] = (0, 1)):
        self.cfg = cfg
        # path sampling and per-item crop RNG derive from the global
        # (seed, step, row), so the concatenation over all parts is
        # bit-identical to the part=(0, 1) stream
        index, count = part
        assert 0 <= index < count, part
        assert cfg.batch_size % count == 0, (cfg.batch_size, count)
        self.part = (int(index), int(count))
        if cfg.lr_dir is not None:
            # paired mode: self.files holds (hr_path, lr_path) tuples and
            # batches are {"hr", "lr"} uint8 dicts
            self.files = list(files) if files is not None \
                else pair_images(cfg.dataset_dir, cfg.lr_dir)
        else:
            self.files = list(files) if files is not None \
                else list_images(cfg.dataset_dir)
        self.seed = seed
        self.step = 0

    # -- resume support: the iterator state goes into the checkpoint
    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.seed, self.step = int(state["seed"]), int(state["step"])

    def _sample_paths(self, step: int) -> List[str]:
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, len(self.files), self.cfg.batch_size)
        return [self.files[i] for i in idx]

    def _make_batch(self, step: int):
        # per-row RNG keyed on the GLOBAL row index, so any (index,
        # count) partition decodes exactly its rows of the same global
        # batch
        paths = self._sample_paths(step)
        index, count = self.part
        local = self.cfg.batch_size // count
        lo = index * local
        rows = range(lo, lo + local)
        row_rng = lambda i: np.random.default_rng(             # noqa: E731
            (self.seed, step, 1, i))
        if self.cfg.lr_dir is not None:
            pairs = [_decode_crop_pair(*paths[i], self.cfg.patch_hw,
                                       self.cfg.scale, row_rng(i))
                     for i in rows]
            return {"hr": np.stack([h for h, _ in pairs]),
                    "lr": np.stack([l for _, l in pairs])}
        return np.stack([
            _decode_crop(paths[i], self.cfg.patch_hw, row_rng(i))
            for i in rows])

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.cfg.n_workers <= 1:
            while True:
                batch = self._make_batch(self.step)
                self.step += 1
                yield batch
            return

        # reorder-buffer pool: workers claim step indices from a shared
        # counter (bounded runahead for backpressure) and deposit
        # (step, batch); the consumer yields strictly in step order, so
        # the multi-worker stream is bit-identical to single-worker and
        # ``self.step`` is always the exact next-to-yield step.
        max_ahead = self.cfg.n_workers + max(2, self.cfg.prefetch * 2)
        cond = threading.Condition()
        stop = threading.Event()
        results: dict = {}
        claim = [self.step]          # next step index a worker may take

        def worker():
            while not stop.is_set():
                with cond:
                    while (claim[0] >= self.step + max_ahead
                           and not stop.is_set()):
                        cond.wait(0.1)
                    if stop.is_set():
                        return
                    step = claim[0]
                    claim[0] += 1
                batch = self._make_batch(step)
                with cond:
                    results[step] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.cfg.n_workers)]
        for t in threads:
            t.start()
        try:
            while True:
                with cond:
                    while self.step not in results:
                        cond.wait(0.1)
                    batch = results.pop(self.step)
                    self.step += 1
                    cond.notify_all()
                yield batch
        finally:
            stop.set()
            with cond:
                cond.notify_all()


class SyntheticPatches:
    """Deterministic random uint8 patches — dataset-free training/bench.

    ``part=(index, count)`` yields those rows of the global batch
    (generated globally, then sliced — the same contract as
    :class:`PatchLoader`)."""

    def __init__(self, cfg: DataConfig, seed: int = 0,
                 part: Tuple[int, int] = (0, 1)):
        self.cfg, self.seed, self.step = cfg, seed, 0
        assert cfg.batch_size % part[1] == 0, (cfg.batch_size, part)
        self.part = (int(part[0]), int(part[1]))

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, state):
        self.seed, self.step = int(state["seed"]), int(state["step"])

    def __iter__(self):
        c = self.cfg
        index, count = self.part
        local = c.batch_size // count
        while True:
            rng = np.random.default_rng((self.seed, self.step))
            self.step += 1
            full = rng.integers(0, 256, (c.batch_size, *c.patch_hw, 3),
                                dtype=np.uint8)
            yield full[index * local:(index + 1) * local]


def device_prefetch(it: Iterator, size: int = 2,
                    device: torch.device | str = "cuda") -> Iterator:
    """Keep ``size`` batches in flight to ``device`` while the current
    one computes.  numpy batches (arrays or paired dicts) become uint8
    tensors; for a CUDA device they go through pinned memory with
    non-blocking copies."""
    device = torch.device(device)

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    buf = collections.deque()
    for batch in it:
        buf.append({k: put(v) for k, v in batch.items()}
                   if isinstance(batch, dict) else put(batch))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
