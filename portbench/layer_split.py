"""The training step split by the program's own spans
(``tdgs_torch.utils.profiler``): host time and device time by layer, host
syncs by site, and the device's idle gaps put down to a layer.

    python3 portbench/layer_split.py [--cell bicycle_mcmc1m.train] [--seed 1]
                                     [--periods 4] [--out chiprun_out/layer_split.json]

On a card, from the cell's set-up (its state, scene and Runner, as
``drivers/train.py`` builds them; no checked steps), it runs:

1. ``--periods`` periods of the cell's ``period`` steps, the tracer off
   and on in turn every few steps, no profiler: the tracer's cost, host
   ms a step on against off (``on_cost``);
2. one period with the tracer on: its ``snapshot``, and the benchmark's
   own ``data`` and ``strategy`` spans, wrapped around the Runner as the
   driver wraps them, beside the program's spans of the same names;
3. with the tracer on, the cell's ``trace_steps`` under ``torch.profiler``:
   each device operation put down to the innermost program span open
   where it was launched (``launch_spans``), the busy time by layer, the
   idle gaps no span covers, and the synchronising runtime calls set
   beside the tracer's ``host_sync`` counts by site (``sync_calls``).

It prints one JSON object (also written to ``--out``) whose ``metrics``
hold the per-layer readings ``metrics()`` makes of the two stretches.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from portbench import harness  # noqa: E402

LAYERS = ("render", "loss", "backward", "adam")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy", "cudaMemcpy2D")


def _chains(ranges: Sequence[Tuple[str, int, int]], times: Sequence[int]):
    """For each time in ``times``: the names of the ranges [(name, start,
    end)] that hold it, outermost first. The ranges nest (the program's
    spans form one stack)."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    rs = sorted(ranges, key=lambda r: (r[1], -r[2]))
    out: List[Tuple[str, ...]] = [()] * len(times)
    stack: List[Tuple[str, int, int]] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(rs) and rs[j][1] <= t:
            while stack and stack[-1][2] < rs[j][1]:
                stack.pop()
            stack.append(rs[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = tuple(r[0] for r in stack if r[1] <= t <= r[2])
    return out


def _annotation(e) -> bool:
    """Is this device event the profiler's copy of a host range (a
    ``record_function`` over the operations it launched), not work?"""
    if e.name().startswith("span:"):
        return True
    is_user = getattr(e, "is_user_annotation", None)
    return bool(is_user()) if is_user is not None else False


def launch_spans(events) -> Dict:
    """The device operations of a ``torch.profiler`` trace (its raw
    ``kineto_results.events()``) put down to the program's spans: each
    operation's runtime launch is found by its correlation id, and the
    spans (``span:`` ranges, on any thread) open at the launch's start are
    its chain, outermost first. The profiler's device copies of host
    ranges are left out. → {"ops": [(name, innermost span or None, start
    s, end s)], "chains": [chain], "spans": [(name, start ns, end ns)],
    "unlaunched": operations with no launch found}."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, launches, device = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not _annotation(e):
                device.append(e)
        elif name.startswith("span:"):
            spans.append((name[5:], e.start_ns(), e.end_ns()))
        elif name.startswith("cuda") or name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    t_launch, found = [], []
    for e in device:
        t = launches.get(e.correlation_id())
        found.append(t is not None)
        t_launch.append(t if t is not None else e.start_ns())
    chains = _chains(spans, t_launch)
    chains = [c if ok else () for c, ok in zip(chains, found)]
    ops = [(e.name(), c[-1] if c else None, e.start_ns() / 1e9, e.end_ns() / 1e9)
           for e, c in zip(device, chains)]
    return {"ops": ops, "chains": chains, "spans": spans,
            "unlaunched": sum(1 for ok in found if not ok)}


def busy_by_layer(attr: Dict, layers: Sequence[str]) -> Dict[str, float]:
    """Seconds of the union of the device operations launched under each
    layer (the layer anywhere in the chain), and under no span (``None``)."""
    out = {}
    for layer in list(layers) + [None]:
        hit = [(s, e) for (_, _, s, e), c in zip(attr["ops"], attr["chains"])
               if (layer in c if layer is not None else not c)]
        out[layer] = sum(e - s for s, e in harness.merged(hit))
    return out


def idle_gaps(attr: Dict) -> Tuple[float, float]:
    """(idle seconds between the device's busy intervals, those of them in
    gaps whose middle no program span covers)."""
    busy = harness.merged([(s, e) for _, _, s, e in attr["ops"]])
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    mids = [0.5 * (a + b) * 1e9 for a, b in gaps]
    covered = _chains(attr["spans"], mids)
    total = sum(b - a for a, b in gaps)
    free = sum(b - a for (a, b), c in zip(gaps, covered) if not c)
    return total, free


def sync_calls(events, sync_sites: Sequence[str]) -> Dict:
    """The synchronising CUDA runtime calls of a trace by where they were
    made: under a ``sync`` span, the site of the matching tracer record
    (the n-th ``span:sync`` range is the n-th ``sync`` record,
    ``sync_sites``); else the innermost span and aten call around them.
    Device-to-host copies (``cudaMemcpyAsync`` whose operation is a DtoH
    memcpy) are counted apart: each host read is one copy and one wait."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dtoh = {e.correlation_id() for e in events
            if e.device_type() == cuda and "DtoH" in e.name() and not _annotation(e)}
    spans, calls, ops = [], [], []
    for e in events:
        if e.device_type() == cuda:
            continue
        name = e.name()
        if name.startswith("span:"):
            spans.append((name[5:], e.start_ns(), e.end_ns()))
        elif name in SYNC_CALLS or (name.startswith("cudaMemcpy")
                                    and e.correlation_id() in dtoh):
            calls.append((name, e.start_ns(), e.start_thread_id()))
        elif name.startswith("aten::"):
            ops.append((name, e.start_ns(), e.end_ns()))
    syncs = sorted(s for s in spans if s[0] == "sync")
    sync_start = [s[1] for s in syncs]
    chains = _chains(spans, [c[1] for c in calls])
    aten = _chains(ops, [c[1] for c in calls])
    by_site: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for (name, t, _), chain, at in zip(calls, chains, aten):
        kind = ("dtoh_copy" if name.startswith("cudaMemcpy") and name not in SYNC_CALLS
                else "wait")
        if chain and chain[-1] == "sync":
            k = bisect.bisect_right(sync_start, t) - 1
            site = sync_sites[k] if 0 <= k < len(sync_sites) else "sync ?"
        else:
            site = "no host_read: " + "/".join(chain) + (f" ({at[-1]})" if at else "")
        by_site[site][kind] += 1
    return {k: dict(v) for k, v in by_site.items()}


def runtime_calls(events, steps: int) -> Dict[str, Dict[str, float]]:
    """The CUDA runtime's calls a step by name: how many, and their host
    ms (allocations, frees and waits hold the host too)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out: Dict[str, Dict[str, float]] = {}
    for e in events:
        name = e.name()
        if e.device_type() != cuda and name.startswith("cu"):
            row = out.setdefault(name, {"count": 0.0, "ms": 0.0})
            row["count"] += 1 / steps
            row["ms"] += (e.end_ns() - e.start_ns()) / 1e6 / steps
    return out


def metrics(program: Optional[Dict], attr: Optional[Dict], traced_steps: int) -> Dict:
    """The per-layer readings of a tracer-on period's ``snapshot()``
    (``program``) and a traced stretch's ``launch_spans`` (``attr``) of
    ``traced_steps`` steps; None where either is missing."""
    out: Dict[str, Optional[float]] = {}
    steps = program.get("steps") if program else 0
    spans = program.get("spans", {}) if program else {}
    for layer in LAYERS:
        row = spans.get(layer)
        out[f"{layer}_host_ms.train"] = 1e3 * row["incl_s"] / steps if row and steps else None
    syncs = (program or {}).get("counts", {}).get("host_sync", {})
    out["host_syncs.train"] = sum(syncs.values()) / steps if steps else None
    out["sync_wait_ms.train"] = (1e3 * spans["sync"]["incl_s"] / steps
                                 if steps and "sync" in spans else None)
    if attr and attr["ops"] and traced_steps:
        busy = busy_by_layer(attr, LAYERS)
        for layer in LAYERS:
            out[f"{layer}_busy_ms.train"] = 1e3 * busy[layer] / traced_steps
        _, free = idle_gaps(attr)
        out["idle_unattributed_ms.train"] = 1e3 * free / traced_steps
    else:
        out.update({f"{layer}_busy_ms.train": None for layer in LAYERS})
        out["idle_unattributed_ms.train"] = None
    return out


def _setup(cell, seed, dev):
    """The cell's Runner at the state after its refine step and warm-up,
    as ``drivers/train.py`` leaves it before the window."""
    from portbench.drivers import train as drv
    from portbench.scenes.state import trained_state

    cfg, traffic = cell.config, cell.traffic
    data_dir = drv.scene_dir(cfg, dev)
    state = trained_state(cfg["state"]["n_gauss"], seed, dev, cfg["state"])
    runner, _, result_dir = drv._program(cfg, state, seed, data_dir, dev)
    del state
    step = drv._train(runner, traffic["check_start"], traffic["check_steps"] + 1)
    step = drv._train(runner, step, traffic["warm_steps"])
    return runner, step, result_dir


BLOCK = 5


def on_cost(runner, step: int, periods: int, period: int) -> Dict:
    """``periods`` runs of ``period`` steps with the tracer switched at
    each step's batch, in blocks of ``BLOCK`` steps off, on, on, off, ...
    (a drift of the host's speed falls on both alike; no profiler) → host
    ms of each step, from one batch to the next, by the tracer's state, and
    the tracer's own cost a call, off and on."""
    from portbench.drivers import train as drv
    from tdgs_torch.utils import profiler as P

    stamps: List[Optional[Tuple[float, bool]]] = []
    inner = runner._batch

    def batch(idx):
        on = len(stamps) // BLOCK % 4 in (1, 2)
        P.enable(on)
        stamps.append((time.perf_counter(), on))
        return inner(idx)

    runner._batch = batch
    try:
        for _ in range(periods):
            drv._train(runner, step, period)
            step += period
            stamps.append(None)
    finally:
        runner._batch = inner
        P.enable(False)
        P.reset_spans()
    steps = {False: [], True: []}
    for a, b in zip(stamps, stamps[1:]):
        if a is not None and b is not None:
            steps[a[1]].append(1e3 * (b[0] - a[0]))
    out = {"off_ms": steps[False], "on_ms": steps[True]}
    for k in ("off", "on"):
        out[f"median_{k}_ms"] = statistics.median(out[f"{k}_ms"])
        out[f"mean_{k}_ms"] = statistics.fmean(out[f"{k}_ms"])
    out["call_ns"] = call_cost()
    return out


def call_cost(n: int = 20000) -> Dict[str, float]:
    """ns a call of ``span`` (entered and left) and of ``host_read`` (of a
    host scalar: the wrapper alone), the tracer off and on."""
    import torch

    from tdgs_torch.utils import profiler as P

    x = torch.tensor(1.0)
    out = {}
    for on in (False, True):
        P.enable(on)
        t = time.perf_counter_ns()
        for _ in range(n):
            with P.span("cost"):
                pass
        out[f"span_{'on' if on else 'off'}"] = (time.perf_counter_ns() - t) / n
        t = time.perf_counter_ns()
        for _ in range(n):
            P.host_read(x, "cost", float)
        out[f"host_read_{'on' if on else 'off'}"] = (time.perf_counter_ns() - t) / n
    t = time.perf_counter_ns()
    for _ in range(n):
        float(x)
    out["plain_read"] = (time.perf_counter_ns() - t) / n
    P.enable(False)
    P.reset_spans()
    return out


def measure(cell, seed: int, periods: int, dev) -> Dict:
    """Both stretches on ``cell`` (``run.load_cell``'s) from ``seed`` on
    ``dev`` → the readings (see the module's docstring)."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.drivers import train as drv
    from tdgs_torch.utils import profiler as P

    period, n_tr = cell.traffic["period"], cell.traffic["trace_steps"]
    runner, step, result_dir = _setup(cell, seed, dev)
    spans = harness.Spans()
    spans.wrap(runner, "_batch", "data")
    spans.wrap(runner, "strategy_post_backward", "strategy")
    harness.sync(dev)
    gc.collect()
    gc.freeze()

    costs = on_cost(runner, step, periods, period)
    step += periods * period

    # one period with the tracer on: its spans, and the benchmark's own
    # spans of the same intervals beside them
    P.reset_spans()
    spans.seconds.clear()
    P.enable(True)
    try:
        step = drv._train(runner, step, period)
        harness.sync(dev)
    finally:
        P.enable(False)
    program = P.snapshot()
    spans.on = False
    beside = {name: {"program_ms": 1e3 * program["spans"][name]["incl_s"] / period,
                     "benchmark_ms": 1e3 * spans.total(name) / period}
              for name in ("data", "strategy")}

    P.reset_spans()
    P.enable(True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                           else [])
    harness.sync(dev)
    try:
        with profile(activities=activities) as prof:
            t = time.perf_counter()
            step = drv._train(runner, step, n_tr)
            harness.sync(dev)
            window = time.perf_counter() - t
    finally:
        P.enable(False)
        gc.unfreeze()
    events = list(prof.profiler.kineto_results.events())
    traced = P.snapshot()
    sync_sites = [r[5] for r in sorted(P.records(), key=lambda r: r[1]) if r[0] == "sync"]
    P.reset_spans()
    runner.close()
    shutil.rmtree(result_dir, ignore_errors=True)

    attr = launch_spans(events)
    busy_all = harness.merged([(s, e) for _, _, s, e in attr["ops"]])
    busy_s = sum(e - s for s, e in busy_all)
    idle_s, free_s = idle_gaps(attr)
    by_layer = busy_by_layer(attr, LAYERS + ("data", "strategy", "log", "step"))
    return {
        "seed": seed, "metrics": metrics(program, attr, n_tr), "on_cost": costs,
        "program_period": program, "beside_benchmark_spans": beside,
        "traced": {
            "steps": n_tr, "window_s": window, "busy_s": busy_s, "idle_s": idle_s,
            "idle_ms_per_step": 1e3 * idle_s / n_tr,
            "idle_unattributed_ms_per_step": 1e3 * free_s / n_tr,
            "busy_ms_per_step_by_span": {str(k): 1e3 * v / n_tr for k, v in by_layer.items()},
            "outside_any_span_share": by_layer[None] / busy_s if busy_s else None,
            "ops": len(attr["ops"]), "unlaunched": attr["unlaunched"],
            "host_syncs": traced["counts"].get("host_sync", {}),
            "sync_calls": sync_calls(events, sync_sites),
            "runtime_calls": runtime_calls(events, n_tr),
            "snapshot": traced,
        },
        "breakdown": harness.breakdown({
            "kernels": [(n, s, e) for n, _, s, e in attr["ops"]],
            "busy_intervals": busy_all,
            "host": [(n, s / 1e9, e / 1e9) for n, s, e in attr["spans"]]}),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="bicycle_mcmc1m.train")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--periods", type=int, default=4)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "layer_split.json"))
    args = ap.parse_args(argv)

    import torch

    from portbench import run

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    run.settle()
    dev = torch.device("cuda")
    _, cell = run.load_cell(args.cell)
    out = dict(measure(cell, args.seed, args.periods, dev), cell=args.cell,
               device=torch.cuda.get_device_name(dev))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fd:
        json.dump(out, fd, indent=1, default=str)
    print(json.dumps(out["metrics"]))
    print(json.dumps({k: out["traced"][k] for k in (
        "idle_ms_per_step", "idle_unattributed_ms_per_step", "outside_any_span_share",
        "busy_ms_per_step_by_span", "host_syncs", "sync_calls", "unlaunched", "ops")}))
    print(json.dumps({k: v for k, v in out["on_cost"].items() if not isinstance(v, list)}))
    print(json.dumps(out["beside_benchmark_spans"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
