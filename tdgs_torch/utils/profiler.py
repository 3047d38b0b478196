"""Profiling utilities (port of ``tdgs/utils/profiler.py``, the
reference's gsplat/profile.py).

- ``timeit``: a decorator or context gated by the environment variable
  ``TIMEIT=1``, adding wall times under a name into the module's
  ``profiler`` dict (shared by every caller in the process, as in the
  reference; ``reset`` clears it). On the card it is fenced by
  ``torch.cuda.synchronize``, so a span holds its device work.
- ``trace``: a ``torch.profiler`` trace written to a log directory for
  TensorBoard or Perfetto.
- ``device_memory_stats``: the card's allocator counters.
"""

from __future__ import annotations

import os
import time
from contextlib import ContextDecorator
from typing import Dict, Optional

import torch

profiler: Dict[str, float] = {}


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class timeit(ContextDecorator):
    """Accumulate wall time under a name when TIMEIT=1 (else no-op)."""

    def __init__(self, name: str):
        self.name = name
        self.enabled = os.environ.get("TIMEIT", "0") == "1"

    def __enter__(self):
        if self.enabled:
            _sync()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            _sync()
            profiler[self.name] = profiler.get(self.name, 0.0) + (
                time.perf_counter() - self.t0)
        return False


def reset() -> None:
    profiler.clear()


def summary() -> str:
    return "\n".join(f"{k}: {v*1000:.2f} ms" for k, v in sorted(profiler.items()))


def trace(log_dir: str):
    """Context manager: a ``torch.profiler`` trace of the CPU and, with a
    card, CUDA activity, written to ``log_dir`` for TensorBoard."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


def device_memory_stats() -> Optional[Dict[str, int]]:
    """The card's allocator counters (``torch.cuda.memory_stats``) with the
    keys ``peak_bytes_in_use`` and ``bytes_in_use`` added; None without a
    card or before it was used."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    stats = dict(torch.cuda.memory_stats())
    stats["peak_bytes_in_use"] = torch.cuda.max_memory_allocated()
    stats["bytes_in_use"] = torch.cuda.memory_allocated()
    return stats
