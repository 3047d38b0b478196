"""Decode-ahead of training images on a thread pool (the port's counterpart
of ``tdgs/datasets/_native.py:122 NativePrefetcher``).

``request(idx)`` queues the decode of ``paths[idx]`` unless it is queued
already; ``get(idx)`` hands over that decode's image, waiting for it if it
is still running, or decodes on the spot an index never requested; each
request serves one ``get``. One ``concurrent.futures.Future`` per index
holds both the ready state and its wakeup, so no wakeup can be lost
between a check and a wait (the race of the JAX package's native loader).
Decoding is ``tdgs_torch.utils.png.imread`` with the loader's integer box
downsampling.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Sequence

import numpy as np

from tdgs_torch.utils.png import imread


def box_downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """uint8 [H, W, C] → [H // f, W // f, C]: the floor of each f×f block's
    mean (the native loader's box filter; the ragged edge is dropped)."""
    if factor <= 1:
        return img
    H, W, C = img.shape
    h, w = H // factor, W // factor
    blocks = img[:h * factor, :w * factor].astype(np.int32).reshape(h, factor, w, factor, C)
    return (blocks.sum(axis=(1, 3)) // (factor * factor)).astype(np.uint8)


def decode(path: str, factor: int = 1) -> np.ndarray:
    """uint8 RGB [H, W, 3] of one image file, box-downsampled by ``factor``."""
    return box_downsample(imread(path), factor)


class Prefetcher:
    """Threaded decode-ahead over a list of image paths."""

    def __init__(self, paths: Sequence[str], factor: int = 1, n_threads: int = 4):
        self.paths = list(paths)
        self.factor = factor
        self._pool = ThreadPoolExecutor(max_workers=n_threads,
                                        thread_name_prefix="tdgs-decode")
        self._pending: Dict[int, Future] = {}
        self._lock = threading.Lock()

    def request(self, idx: int) -> None:
        """Queue the decode of image ``idx`` (no-op if it is queued)."""
        with self._lock:
            if self._pool is None:
                raise RuntimeError("the prefetcher is closed")
            if idx not in self._pending:
                self._pending[idx] = self._pool.submit(decode, self.paths[idx], self.factor)

    def get(self, idx: int) -> np.ndarray:
        """The image ``idx``: its queued decode's result (waiting for it), or
        a decode here and now if it was not requested. A decode's exception
        is raised here."""
        with self._lock:
            future = self._pending.pop(idx, None)
        if future is None:
            return decode(self.paths[idx], self.factor)
        return future.result()

    def close(self) -> None:
        """Cancel the queued decodes and join the threads."""
        with self._lock:
            pool, self._pool = self._pool, None
            self._pending.clear()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
