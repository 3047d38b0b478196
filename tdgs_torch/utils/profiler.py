"""Profiling utilities (port of ``tdgs/utils/profiler.py``, the
reference's gsplat/profile.py), and the program's tracer.

- The tracer: ``span(name)`` records a named host interval on
  ``time.perf_counter_ns()``, nested under the span open around it, and
  opens ``torch.profiler.record_function("span:" + name)``, so that under
  a ``torch.profiler`` trace each span sits beside the device operations
  it launched, on the profiler's clock. ``host_read(x, site)`` is the one
  way the training step brings a device value to the host: counted as
  ``host_sync`` under its site and timed as a child span ``sync``.
  ``count`` adds to a named counter. Off by default (``enable``; or
  ``TIMEIT=1`` at import): then ``span`` returns one shared no-op and
  ``count`` returns at once. ``snapshot`` sums the recorded spans by name.
  The spans stay in memory until ``reset_spans``.
- ``timeit``: a decorator or context gated by the environment variable
  ``TIMEIT=1``, adding wall times under a name into the module's
  ``profiler`` dict (shared by every caller in the process, as in the
  reference; ``reset`` clears it). On the card it is fenced by
  ``torch.cuda.synchronize``, so a span holds its device work. It records
  through the tracer's span, whatever the tracer's switch.
- ``trace``: a ``torch.profiler`` trace written to a log directory for
  TensorBoard or Perfetto; the tracer's spans appear in it as ``span:``
  ranges.
- ``device_memory_stats``: the card's allocator counters.

The spans of one process form one stack: autograd's device thread, which
runs a backward's Python while the calling thread waits for it, nests its
spans under the caller's open span.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import ContextDecorator
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

profiler: Dict[str, float] = {}

# the tracer's switch, records and counters; a record is
# [name, start ns, end ns (None while open), parent index (-1: none), step, site]
_on = os.environ.get("TIMEIT", "0") == "1"
_records: List[list] = []
_stack: List[int] = []
_counts: Dict[Tuple[str, str], int] = defaultdict(int)


def enable(on: bool) -> None:
    """Switch the tracer on or off (the records are kept)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


class _NoSpan:
    """The span of a tracer that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


class _Span:
    __slots__ = ("name", "step", "site", "index", "range")

    def __init__(self, name: str, step: Optional[int], site: Optional[str]):
        self.name, self.step, self.site = name, step, site

    def __enter__(self):
        parent = _stack[-1] if _stack else -1
        step = self.step
        if step is None and parent >= 0:
            step = _records[parent][4]
        # the profiler's range opens first and closes last: it holds the
        # recorded interval
        self.range = torch.profiler.record_function("span:" + self.name)
        self.range.__enter__()
        self.index = len(_records)
        _records.append([self.name, time.perf_counter_ns(), None, parent, step, self.site])
        _stack.append(self.index)
        return self

    def __exit__(self, *exc):
        _records[self.index][2] = time.perf_counter_ns()
        _stack.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, step: Optional[int] = None, site: Optional[str] = None):
    """Context manager: a named host interval under the span open around
    it. ``step`` marks the span of one training step: the spans inside it
    take its number. ``site`` names where a ``sync`` span read. With the
    tracer off, the shared no-op."""
    if not _on:
        return _NOOP
    return _Span(name, step, site)


def count(name: str, site: str = "", n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` under ``site`` (tracer on only)."""
    if not _on:
        return
    _counts[(name, site)] += n


def host_read(x: Any, site: str, read: Callable[[Any], Any] = torch.Tensor.item) -> Any:
    """``read(x)``: a read of a device value on the host (``int``,
    ``float`` or ``bool`` of a 0-d tensor; ``item`` by default), or a
    transfer that waits for the device. With the tracer on it counts
    ``host_sync`` under ``site`` and is timed as a ``sync`` span."""
    if not _on:
        return read(x)
    _counts[("host_sync", site)] += 1
    with _Span("sync", None, site):
        return read(x)


def reset_spans() -> None:
    """Drop the recorded spans and counters."""
    _records.clear()
    _stack.clear()
    _counts.clear()


def snapshot() -> Dict[str, Any]:
    """The closed spans summed by name → {"steps": the number of step
    ids seen, "spans": {name: {"count", "incl_s", "self_s"}} (self: a
    span's time less its child spans'), "counts": {counter: {site: n}},
    "sync_s": {site: seconds in ``sync`` spans}}."""
    closed = [(i, r) for i, r in enumerate(_records) if r[2] is not None]
    children = defaultdict(int)
    for _, r in closed:
        if r[3] >= 0:
            children[r[3]] += r[2] - r[1]
    spans: Dict[str, Dict[str, float]] = {}
    sync_s: Dict[str, float] = defaultdict(float)
    for i, r in closed:
        d = r[2] - r[1]
        row = spans.setdefault(r[0], {"count": 0, "incl_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["incl_s"] += d / 1e9
        row["self_s"] += (d - children[i]) / 1e9
        if r[0] == "sync":
            sync_s[r[5]] += d / 1e9
    counts: Dict[str, Dict[str, int]] = defaultdict(dict)
    for (name, site), n in _counts.items():
        counts[name][site] = n
    return {"steps": len({r[4] for _, r in closed if r[4] is not None}), "spans": spans,
            "counts": dict(counts), "sync_s": dict(sync_s)}


def records() -> List[Tuple[str, int, Optional[int], int, Optional[int], Optional[str]]]:
    """The recorded spans in the order they opened: (name, start ns, end
    ns, parent index or -1, step, site)."""
    return [tuple(r) for r in _records]


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
            self.span = _Span(self.name, None, None).__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            _sync()
            self.span.__exit__(*exc)
            _, start, end = _records[self.span.index][:3]
            profiler[self.name] = profiler.get(self.name, 0.0) + (end - start) / 1e9
        return False


def reset() -> None:
    """Clear ``timeit``'s totals and the tracer's records."""
    profiler.clear()
    reset_spans()


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
