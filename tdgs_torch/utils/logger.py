"""Training metrics logging (port of ``tdgs/utils/logger.py``): JSONL
always, TensorBoard events when the ``tensorboard`` package imports.

The canonical sink is ``{result_dir}/metrics.jsonl``, one JSON object per
logged step, readable without any dependency; the TensorBoard mirror
(``{result_dir}/tb``) is optional, a sink and not a device path. It writes
scalar events through tensorboard's own event-file writer, the events
``torch.utils.tensorboard.SummaryWriter.add_scalar`` writes, without the
TensorFlow import that ``SummaryWriter`` makes where TensorFlow is
installed.
"""

from __future__ import annotations

import json
import numbers
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Append-only scalar logger with an optional TensorBoard mirror."""

    def __init__(self, result_dir: str, use_tensorboard: bool = True):
        os.makedirs(result_dir, exist_ok=True)
        self._path = os.path.join(result_dir, "metrics.jsonl")
        self._f = open(self._path, "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboard.summary.writer.event_file_writer import EventFileWriter
            except ImportError:  # no tensorboard package: JSONL only
                EventFileWriter = None
            if EventFileWriter is not None:
                self._tb = EventFileWriter(os.path.join(result_dir, "tb"))

    @property
    def path(self) -> str:
        return self._path

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        """One record: ``step``, the wall time and every scalar as a float
        (``None`` and non-numbers are left out). Tensors of one element
        count as numbers."""
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            if hasattr(v, "item"):  # a one-element tensor or numpy scalar
                v = v.item()
            if isinstance(v, numbers.Number):
                rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary

            for k, v in rec.items():
                if k not in ("step", "time"):
                    self._tb.add_event(Event(
                        wall_time=rec["time"], step=int(step),
                        summary=Summary(value=[Summary.Value(tag=k, simple_value=v)])))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def device_mem_gb() -> Optional[float]:
    """Peak device memory in GiB (``profiler.device_memory_stats``'s
    ``peak_bytes_in_use``), or None without a card."""
    from tdgs_torch.utils.profiler import device_memory_stats

    stats = device_memory_stats()
    if not stats:
        return None
    peak = stats.get("peak_bytes_in_use") or stats.get("bytes_in_use")
    return None if peak is None else peak / (1 << 30)
