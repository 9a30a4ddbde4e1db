"""Watch-directory serving: one resident process with the generator on
the card, upscaling each new frame as it lands (the JAX package's
``serve.py``).

Mechanics: poll the watch dir (os.scandir — no inotify dependency),
claim each unprocessed image by its (mtime, size) signature, upscale it
through the tiled path, write ``<stem>_x<scale>.png`` to the output dir
and append a JSONL record (frame, shapes, seconds, MP/s) to
``serve_log.jsonl``.  A frame is reprocessed if its file changes.  Files
still being written are skipped until their signature is stable across
two polls.  The durable record of what was processed is the output
file's mtime, so a restarted server skips frames it already wrote.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from super_resolution_tpu_torch.data.pipeline import IMAGE_EXTS


def _signature(path: str) -> Optional[Tuple[float, int]]:
    try:
        st = os.stat(path)
        return (st.st_mtime, st.st_size)
    except OSError:
        return None


def _scan(watch_dir: str) -> Dict[str, Tuple[float, int]]:
    out = {}
    try:
        with os.scandir(watch_dir) as it:
            for e in it:
                if e.is_file() and e.name.lower().endswith(IMAGE_EXTS):
                    st = e.stat()
                    out[e.path] = (st.st_mtime, st.st_size)
    except FileNotFoundError:
        pass
    return out


def serve_watch(
        upscale_fn: Callable[[np.ndarray], np.ndarray],
        watch_dir: str,
        out_dir: str,
        scale: int = 4,
        poll_s: float = 0.5,
        once: bool = False,
        max_frames: Optional[int] = None,
        log_path: Optional[str] = None,
        pipeline_write: bool = True,
        device: str | torch.device = "cuda",
) -> int:
    """Run the watch loop.  ``upscale_fn``: uint8 HWC LR → uint8 HWC SR.
    ``once`` drains the current backlog and returns; otherwise loops
    until ``max_frames`` are processed (None = forever).  Returns the
    number of frames processed; all outputs are on disk when it returns.
    ``device`` is where the alpha plane is upscaled.

    ``pipeline_write`` (default on) moves PNG encode + save + log append
    into one background writer thread behind a depth-1 queue, so the
    encode of frame N overlaps the decode and compute of frame N+1; a
    single FIFO writer keeps output and log order.  A writer failure is
    re-raised here after the writer has stopped."""
    from PIL import Image

    from super_resolution_tpu_torch.data.image_io import (
        merge_alpha,
        split_alpha,
    )

    os.makedirs(out_dir, exist_ok=True)
    log_path = log_path or os.path.join(out_dir, "serve_log.jsonl")
    done: Dict[str, Tuple[float, int]] = {}
    pending: Dict[str, Tuple[float, int]] = {}
    n = 0

    def _save_and_log(dst, arr, rec):
        Image.fromarray(arr).save(dst)
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[serve] {rec['frame']}: {rec['lr'][1]}x{rec['lr'][0]} → "
              f"{rec['sr'][1]}x{rec['sr'][0]} in {rec['seconds']:.2f}s "
              f"({rec['mp_per_sec']} MP/s)", flush=True)

    wq = werr = wt = None
    if pipeline_write:
        wq = queue.Queue(maxsize=1)
        werr = []

        def _writer():
            while True:
                item = wq.get()
                try:
                    if item is None:
                        return
                    _save_and_log(*item)
                except Exception as e:    # handed to the serve thread
                    werr.append(e)
                finally:
                    wq.task_done()

        wt = threading.Thread(target=_writer, daemon=True,
                              name="serve-writer")
        wt.start()

    def _flush(count: int) -> int:
        if wq is not None:
            wq.join()
            wq.put(None)
            wt.join()
            if werr:
                raise werr[0]
        return count

    while True:
        seen = _scan(watch_dir)
        for path, sig in sorted(seen.items()):
            if werr:
                return _flush(n)            # re-raises the writer error
            if done.get(path) == sig:
                continue
            stem, _ = os.path.splitext(os.path.basename(path))
            dst = os.path.join(out_dir, f"{stem}_x{scale}.png")
            # restart resilience: an output at least as new as the input
            # counts as processed
            dsig = _signature(dst)
            if dsig is not None and dsig[0] >= sig[0]:
                done[path] = sig
                continue
            # a stable signature across two polls: no half-written frames
            if not once and pending.get(path) != sig:
                pending[path] = sig
                continue
            pending.pop(path, None)

            sig2 = _signature(path)
            if sig2 is None:
                continue
            with Image.open(path) as im:
                lr_u8, alpha_u8 = split_alpha(im)
            t0 = time.perf_counter()
            sr_u8 = np.asarray(upscale_fn(lr_u8))
            dt = time.perf_counter() - t0
            # alpha rides plain bicubic, outside the model's timing window
            sr_u8 = merge_alpha(sr_u8, alpha_u8, scale, device)
            done[path] = sig2
            n += 1
            rec = {
                "frame": os.path.basename(path),
                "lr": list(lr_u8.shape[:2]),
                "sr": list(sr_u8.shape[:2]),
                "seconds": round(dt, 4),
                "mp_per_sec": round(
                    sr_u8.shape[0] * sr_u8.shape[1] / 1e6 / max(dt, 1e-9),
                    3),
            }
            if wq is not None:
                wq.put((dst, sr_u8, rec))
            else:
                _save_and_log(dst, sr_u8, rec)
            if max_frames is not None and n >= max_frames:
                return _flush(n)

        if werr or once:
            return _flush(n)                # re-raises a writer error
        time.sleep(poll_s)
