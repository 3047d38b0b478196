"""The comparisons that decide ``correct``: each number compared has a
limit of its own (``limits`` in ``workloads/<cell>.json``, set from the sound
runs' readings and the control's), and a run is correct when every number
is finite and within its limit and no unit of work failed."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch


def leaf_norm_gap(prog: Dict[str, float], ref: Dict[str, float],
                  skip: Iterable[str] = ()) -> Tuple[float, Optional[str]]:
    """The worst leaf's |‖program‖ − ‖reference‖| over the larger of the
    reference's norm of that leaf and of the median leaf → (gap, leaf)."""
    names = [k for k in ref if k not in set(skip)]
    if not names:
        return 0.0, None
    med = statistics.median(ref[k] for k in names)
    worst, leaf = -1.0, None
    for k in names:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(g):
            return math.inf, k
        if g > worst:
            worst, leaf = g, k
    return worst, leaf


def nought_leaves(grad_norms: Dict[str, float], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is under ``share`` of the median
    leaf's: Adam moves them by round-off alone."""
    med = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v < share * med]


def verdict(compared: Dict[str, Dict[str, float]], failed: int) -> bool:
    """Every number finite and within its limit, and no unit failed."""
    ok = failed == 0
    for row in compared.values():
        v = row["value"]
        ok = ok and v is not None and math.isfinite(v) and v <= row["limit"]
    return bool(ok)


def compared(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    return {k: {"value": float(values[k]), "limit": float(limits[k])} for k in limits}


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree
