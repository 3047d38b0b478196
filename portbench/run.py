"""One run of one benchmark cell of the PyTorch/CUDA port (``tdgs_torch``)
on the cards of the machine it runs on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration is ``portbench/configs/<config>.json``, its traffic
``portbench/traffic/<traffic>.json`` (whose ``kind`` names the driver in
``portbench/drivers/``), its limits ``portbench/workloads/<cell>.json``,
and each per-layer metric is read by ``portbench/metrics/<metric>.py``. A
cell or a metric is added by adding files and entries.

With ``--trace 0`` the result reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. The numbers compared with the
reference are printed beside their limits as the last lines of standard
error and under ``compared``, last in the result. The result is the last
line of standard output. Without a card, or with fewer cards than the cell
asks for, the run fails and prints no result; so it does when a module of
``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded, or when a
source under ``portbench/`` imports one (or the reference imports the
system).
"""

from __future__ import annotations

import argparse
import ast
import importlib
import importlib.util
import json
import os
import sys
from types import ModuleType, SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

T_START = harness.process_start()
FORBIDDEN = ("jax", "jaxlib", "flax", "tdgs")
SYSTEM = "tdgs_torch"


def imported_roots(path: str):
    """Top-level names of every module a source file imports."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def source_violations():
    """(file, name) of every import under portbench/ of a forbidden
    package, and of the system from the reference."""
    bad = []
    for d, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            in_ref = os.path.join(HERE, "reference") in path
            for name in imported_roots(path):
                if name in FORBIDDEN or (in_ref and name == SYSTEM):
                    bad.append((os.path.relpath(path, ROOT), name))
    return bad


def loaded_violations():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(name: str):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fd:
        bench = json.load(fd)
    (w,) = [w for w in bench["workloads"] if w["name"] == name]

    def data(*parts):
        with open(os.path.join(HERE, *parts)) as fd:
            return json.load(fd)

    return bench, SimpleNamespace(
        name=name, chips=w["chips"], config=data("configs", w["config"] + ".json"),
        traffic=data("traffic", w["traffic"] + ".json"),
        limits=data("workloads", name + ".json")["limits"])


def metrics_of(bench, cell_name: str, kind: str):
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def read_metric(name: str, ctx):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric", os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def settle() -> None:
    """What every process that runs the system sets first: float32 matmuls
    without TF32, as the configurations state, and tensorboard (which the
    trainer's log writes through, and which imports TensorFlow, and with it
    JAX, where they are installed) kept on its stub by its own switch, the
    ``notf`` module."""
    import torch

    sys.modules.setdefault("tensorboard.compat.notf", ModuleType("tensorboard.compat.notf"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bad = source_violations()
    if bad:
        print(f"portbench imports what it may not: {bad}", file=sys.stderr)
        return 3
    bench, cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    settle()
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    return report(bench, cell, out, bool(args.trace))


def report(bench, cell, out, trace: bool) -> int:
    loaded = loaded_violations()
    if loaded:
        print(f"loaded in this process: {loaded}", file=sys.stderr)
        return 3
    metrics = {}
    if trace:
        for m in metrics_of(bench, cell.name, "per_layer"):
            v = read_metric(m["name"], out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, cell.name, "end_to_end"):
            metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    device = dict(out["device"])
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        tr = out["ctx"]["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = harness.breakdown(tr)
    line["compared"] = out["compared"]
    for k, row in out["compared"].items():
        print(f"{k} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
