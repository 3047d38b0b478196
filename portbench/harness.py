"""What every cell's driver shares: the run's start time, host spans
around the system's calls, the profiler's reading of a traced stretch, and
the device's record."""

from __future__ import annotations

import bisect
import functools
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(CHECKOUT, ".portbench_cache")


def process_start() -> float:
    """The wall-clock time (``time.time()``) at which this process
    started, from /proc; the import of this module where /proc is absent."""
    try:
        with open("/proc/self/stat") as fd:
            ticks = int(fd.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fd:
            btime = next(int(l.split()[1]) for l in fd if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


class Spans:
    """Host durations by name, taken around calls into the system. A
    wrapped call also opens a profiler range of the same name, so a traced
    stretch can name what the host did while the device sat idle."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.on = True

    def wrap(self, obj, method: str, name: str) -> None:
        """Replace ``obj.method`` on the instance by a timed call."""
        inner = getattr(obj, method)

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            if not self.on:
                return inner(*args, **kwargs)
            with torch.profiler.record_function(f"span:{name}"):
                t0 = time.perf_counter()
                try:
                    return inner(*args, **kwargs)
                finally:
                    self.seconds[name].append(time.perf_counter() - t0)

        setattr(obj, method, timed)

    def total(self, name: str) -> float:
        return float(sum(self.seconds.get(name, ())))

    def count(self, name: str) -> int:
        return len(self.seconds.get(name, ()))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def profile(fn: Callable[[], None], device) -> Dict:
    """Run ``fn`` under ``torch.profiler`` → the traced stretch's device
    operations [(name, start s, end s)], their busy union, the stretch's
    length by the host clock, and the host's ranges [(name, start s, end
    s)]: the spans' own, then each thread's outermost calls. Read from the
    profiler's raw events: building its Python event tree takes minutes
    for a few hundred thousand launches."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        window = time.perf_counter() - t0
    kernels, host, calls = [], [], {}
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append(row)
        elif row[0].startswith("span:"):
            host.append((row[0][5:],) + row[1:])
        else:
            calls.setdefault(e.start_thread_id(), []).append(row)
    for rows in calls.values():
        end = float("-inf")
        for row in sorted(rows, key=lambda r: (r[1], -r[2])):
            if row[1] >= end:
                host.append(row)
                end = row[2]
    busy = merged([(s, e) for _, s, e in kernels])
    return {"kernels": kernels, "busy_s": sum(e - s for s, e in busy), "window_s": window,
            "busy_intervals": busy, "host": host}


class DeviceBusy:
    """The profiler tracing the device alone over a stretch: the union of
    its operation intervals, the time the card was kept busy. ``start`` is
    called in set-up, so the tracer's own start-up is set-up's."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        sync(self.device)
        self.prof = torch_profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self) -> Tuple[float, int]:
        """→ (busy seconds, device operations) since ``start``."""
        sync(self.device)
        self.prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        ops = [(e.start_ns(), e.end_ns()) for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        self.prof = None
        return sum(e - s for s, e in merged(ops)) / 1e9, len(ops)


def breakdown(tr: Dict, top: int = 10) -> Dict:
    """The device operations that took the most time, and the longest idle
    gaps by what the host was doing (the shortest span or outermost call
    under the gap's middle), each summed by name."""
    ops: Dict[str, float] = defaultdict(float)
    for name, s, e in tr["kernels"]:
        ops[name[:100]] += e - s
    busy = tr["busy_intervals"]
    gaps = sorted((0.5 * (e0 + s1), s1 - e0) for (_, e0), (s1, _) in zip(busy, busy[1:]))
    mids = [m for m, _ in gaps]
    names = ["host, outside any call"] * len(gaps)
    # each gap takes the shortest range over it: ranges in order of length,
    # each naming the gaps under it that no shorter range named
    nxt = list(range(len(gaps) + 1))

    def free(i):
        while nxt[i] != i:
            nxt[i] = nxt[nxt[i]]
            i = nxt[i]
        return i

    for name, s, e in sorted(tr["host"], key=lambda r: r[2] - r[1]):
        i = free(bisect.bisect_left(mids, s))
        while i < len(gaps) and mids[i] < e:
            names[i] = name
            nxt[i] = i + 1
            i = free(i + 1)
    idle: Dict[str, float] = defaultdict(float)
    for name, (_, length) in zip(names, gaps):
        idle[name[:100]] += length
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[k, v] for k, v in order(ops)],
            "idle_gaps": [[k, v] for k, v in order(idle)]}


def kernel_seconds(tr: Dict, names) -> Optional[float]:
    """Summed device time of the kernels whose name holds one of
    ``names``; None where none ran."""
    hits = [e - s for n, s, e in tr["kernels"] if any(k in n for k in names)]
    return float(sum(hits)) if hits else None


def device_record(device) -> Dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}

