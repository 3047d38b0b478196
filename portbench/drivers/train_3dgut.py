"""Traffic of kind ``train_3dgut``: the system's trainer (``Runner.train``)
training 3DGUT (``Config(with_ut=True, with_eval3d=True)``: the unscented
projection tiles, kernels 7 and 8 composite along the pixels' rays) under
MCMC, on the scene and from the state of ``drivers/train.py``, in whole
refine periods.

Set-up, the checked steps, the window and the comparison are the 3DGS
driver's (its helpers are imported): the stream is sized by the plan of
the projection that tiles the render (``derive_isect_plan(with_ut=True)``),
the tile capacity is the configuration's, and a step that drops an entry,
from the stream or from a tile, fails the run. The reference is
``reference/train_3dgut.py``. The traced run reads the device as the 3DGS
driver does (the program's tracer off), then runs one period with the
tracer on (its ``snapshot``), then ``trace_steps`` with the tracer on under
a profiler of its own, each device operation put down to the span that
launched it (``layer_split.launch_spans``)."""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from portbench import check, harness, layer_split
from portbench.drivers.train import (
    B1,
    _Checked,
    _norms,
    _train,
    cameras,
    compare,
    relocation_gap,
    scene_dir,
    scene_scale,
    train_views,
)
from portbench.reference import train_3dgut as ref_train
from portbench.scenes.state import trained_state
from portbench.work import counts_3dgut as counts


def _ut_options(cfg: Dict) -> Dict:
    """The projection's options as the configuration states them; the
    render takes the system's defaults, so they must be those."""
    from tdgs_torch.ops.projection_ut import UnscentedTransformParameters

    ut = UnscentedTransformParameters(**cfg["ut_params"])
    if ut != UnscentedTransformParameters():
        raise ValueError(f"the render takes the default UT parameters, not {ut}")
    if not (cfg["with_ut"] and cfg["with_eval3d"]):
        raise ValueError("a 3DGUT configuration projects by UT and rasterizes by eval3d")
    return {"camera_model": cfg["camera_model"], "ut_params": ut}


def _program(cfg, state, seed, data_dir, device):
    from tdgs_torch.ops.tiling import derive_isect_plan
    from tdgs_torch.strategy import MCMCStrategy
    from tdgs_torch.training.config import Config
    from tdgs_torch.training.trainer import Runner

    tr, sc, rc = cfg["trainer"], cfg["scene"], cfg["render"]
    n = cfg["state"]["n_gauss"]
    ut = _ut_options(cfg)
    strategy = MCMCStrategy(cap_max=tr["cap_max"], noise_lr=tr["noise_lr"],
                            refine_start_iter=tr["refine_start_iter"],
                            refine_stop_iter=tr["refine_stop_iter"],
                            refine_every=tr["refine_every"])
    vms, K = cameras(cfg, device)
    # the stream as the render tiles it: by the unscented projection
    plans = [derive_isect_plan(state["means"], state["quats"], torch.exp(state["scales"]),
                               torch.sigmoid(state["opacities"]), vms[i:i + 1], K[None],
                               sc["width"], sc["height"],
                               max_tiles_per_gauss=rc["max_tiles_per_gauss"],
                               headroom=rc["isect_headroom"], device=device, with_ut=True,
                               **ut)
             for i in range(len(vms))]
    demand = max(p["full_isect_demand"] for p in plans)
    plan = {"isect_capacity": -(-int(demand * rc["isect_headroom"]) // 4096) * 4096,
            "full_isect_demand": demand,
            "footprint_kmax": max(p["footprint_kmax"] for p in plans),
            "tile_capacity": rc["tile_capacity"]}
    result_dir = tempfile.mkdtemp(prefix="portbench-train-3dgut-")
    config = Config(
        data_dir=data_dir, data_factor=sc["data_factor"], result_dir=result_dir,
        test_every=sc["test_every"], normalize_world_space=False,
        max_steps=tr["max_steps"], eval_steps=[], save_steps=[], ply_steps=[],
        sh_degree=tr["sh_degree"], init_opa=tr["init_opa"], init_scale=tr["init_scale"],
        opacity_reg=tr["opacity_reg"], scale_reg=tr["scale_reg"],
        ssim_lambda=tr["ssim_lambda"], batch_size=tr["batch_size"],
        rasterizer=tr["rasterizer"], strategy=strategy, capacity=n,
        camera_model=ut["camera_model"], with_ut=True, with_eval3d=True,
        tile_capacity=plan["tile_capacity"],
        isect_capacity=plan["isect_capacity"], isect_exact=True,
        max_tiles_per_gauss=rc["max_tiles_per_gauss"], seed=seed)
    runner = Runner(config, device=device)
    runner.splats = {k: v.clone() for k, v in state.items()}
    runner.capacity = n
    runner.opt_state = runner.optimizer.init(runner.splats)
    runner.strategy_state = dict(runner.strategy_state, n_alive=n)
    return runner, plan, result_dir


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False, fault: str = "") -> Dict:
    """One run of the cell; with ``control`` no system runs: the reference
    in bfloat16 takes its place on the same inputs, or with ``fault="half"``
    the reference with half of the batch left out."""
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    data_dir = scene_dir(cfg, dev)
    seeds = {"noise": (seed * 2654435761 + 97) % (1 << 63),
             "reloc": (seed * 40503 + 12345) % (1 << 63)}
    start = traffic["check_start"]
    n_chain = traffic["check_steps"]
    chain = list(range(start + 1, start + 1 + n_chain))
    refine = start + n_chain + 1
    if refine % cfg["trainer"]["refine_every"]:
        raise ValueError(f"step {refine} after the chain is not a refine step")
    out: Dict = {"attempted": 0, "failed": 0, "metrics": {}, "ctx": {}}
    state = trained_state(cfg["state"]["n_gauss"], seed, dev, cfg["state"])
    s0 = check.to_host(state)
    if control:
        del state
        ids = [int(x) for x in np.random.default_rng(seed).choice(train_views(cfg), n_chain)]
        prog = reference_steps(cfg, s0, data_dir, ids, chain, seeds["noise"], dev,
                               torch.float32 if fault == "half" else torch.bfloat16,
                               half=fault == "half")
    else:
        prog = _program_run(cell, state, seed, seconds, trace, dev, t_start, data_dir, seeds,
                            out)
        del state
    refd = reference_steps(cfg, s0, data_dir, prog["image_ids"], chain, seeds["noise"], dev,
                           torch.float32)
    values = compare(prog, refd)
    if not control:
        values["reloc_gap"], values["draw_z"], leaf = relocation_gap(prog["reloc"],
                                                                     seeds["reloc"], cfg, dev)
        print(f"relocation: worst leaf {leaf}; plan {out['ctx'].get('plan')}; steps with "
              f"dropped entries {out['failed']}", file=sys.stderr)
    out["values"] = values
    out["compared"] = check.compared({k: values.get(k, 0.0) for k in cell.limits}, cell.limits)
    out["correct"] = check.verdict(out["compared"], out["failed"])
    sc = cfg["scene"]
    pixels = sc["width"] * sc["height"]
    n = cfg["state"]["n_gauss"]
    rows = list(zip(refd["visible"], refd["live_pairs"], refd["entries"]))
    work = [counts.train_step(n, v, lp, e, pixels) for v, lp, e in rows]
    comp = [(counts.composite(lp, e, v, pixels), counts.composite(lp, e, v, pixels, True))
            for v, lp, e in rows]
    out["ctx"]["work"] = {
        "step": {k: float(np.mean([w[k] for w in work])) for k in ("flops", "bytes")},
        "composite": {k: float(np.mean([a[k] + b[k] for a, b in comp]))
                      for k in ("flops", "bytes")},
    }
    return out


def _traced(runner, step: int, traffic: Dict, dev, out: Dict) -> None:
    """The traced run's three stretches after the window: the device
    (tracer off) → ``ctx["trace"]``; one period with the tracer on →
    ``ctx["program"]`` (its ``snapshot``); ``trace_steps`` with the tracer
    on under a profiler → ``ctx["attr"]`` (``launch_spans``)."""
    from torch.profiler import ProfilerActivity, profile

    from tdgs_torch.utils import profiler as P

    n_tr = traffic["trace_steps"]
    tr = harness.profile(lambda: _train(runner, step, n_tr), dev)
    step += n_tr
    out["ctx"].update(trace=tr, traced_units=n_tr)
    P.reset_spans()
    P.enable(True)
    try:
        step = _train(runner, step, traffic["period"])
        harness.sync(dev)
        out["ctx"]["program"] = P.snapshot()
        P.reset_spans()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                               else [])
        with profile(activities=activities) as prof:
            _train(runner, step, n_tr)
            harness.sync(dev)
    finally:
        P.enable(False)
        P.reset_spans()
    out["ctx"].update(attr=layer_split.launch_spans(prof.profiler.kineto_results.events()),
                      attr_units=n_tr)


def _program_run(cell, state, seed, seconds, trace, dev, t_start, data_dir, seeds, out):
    """Set-up from ``state``, the checked steps and the window of the
    system (as ``drivers/train.py``'s) → its readings of the checked steps;
    the run's numbers go into ``out``."""
    cfg, traffic = cell.config, cell.traffic
    start, n_chain = traffic["check_start"], traffic["check_steps"]
    runner, plan, result_dir = _program(cfg, state, seed, data_dir, dev)
    spans = harness.Spans()
    spans.wrap(runner, "_batch", "data")
    checked = _Checked(runner, state, n_chain, start + n_chain + 1, seeds["reloc"])
    spans.wrap(runner, "strategy_post_backward", "strategy")
    image_ids = []
    batch_inner = runner._batch

    def batch(idx):
        b = batch_inner(idx)
        if checked.record and len(image_ids) < n_chain:
            image_ids.append(train_views(cfg)[int(b["image_id"][0])])
        return b

    runner._batch = batch
    runner.generator.manual_seed(seeds["noise"])
    step = _train(runner, start, n_chain + 1)
    prog = {
        "loss": [float(x) for x in checked.losses],
        "grad": _norms({k: v / (1 - B1) for k, v in checked.mu1.items()}),
        "change": checked.change,
        "image_ids": list(image_ids),
        "reloc": checked.reloc,
    }
    checked.record = False
    checked.mu1 = None
    step = _train(runner, step, traffic["warm_steps"])
    spans.seconds.clear()
    harness.sync(dev)
    gc.collect()
    gc.freeze()
    busy = harness.DeviceBusy(dev) if dev.type == "cuda" and not trace else None
    if busy is not None:
        busy.start()
    setup_s = time.time() - t_start

    t0 = time.perf_counter()
    n_window, periods = 0, []
    while True:
        t = time.perf_counter()
        step = _train(runner, step, traffic["period"])
        periods.append([round(time.perf_counter() - t, 4)]
                       + [round(spans.total(k), 4) for k in ("data", "strategy")])
        n_window += traffic["period"]
        if time.perf_counter() - t0 >= seconds:
            break
    harness.sync(dev)
    window = time.perf_counter() - t0
    gc.unfreeze()
    out["metrics"] = {"setup_s": setup_s}
    if busy is not None:
        t = time.perf_counter()
        busy_s, n_ops = busy.stop()
        out["metrics"]["train_device_ms_per_step"] = 1e3 * busy_s / n_window
        print(f"window: {n_window} steps, {n_ops} device operations, busy {busy_s} s of "
              f"{window} s; the trace read in {time.perf_counter() - t:.1f} s", file=sys.stderr)
    finite = all(bool(torch.isfinite(v).all()) for v in runner.splats.values())
    out["attempted"] = n_window + n_chain + 1 + traffic["warm_steps"]
    out["failed"] = checked.dropped + (0 if finite else 1)
    print(f"window: periods of {traffic['period']} steps took [s, data s so far, strategy s "
          f"so far] {periods}", file=sys.stderr)
    spans.on = False
    if trace:
        _traced(runner, step, traffic, dev, out)
    out["ctx"].update(spans=spans, window_units=n_window, window_s=window, plan=plan)
    out["device"] = harness.device_record(dev)
    runner.close()
    del runner, checked
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(result_dir, ignore_errors=True)
    return prog


def reference_steps(cfg, s0, data_dir, image_ids, steps, noise_seed, dev, dtype,
                    half=False):
    """The reference's 3DGUT steps from the same state → losses, the first
    step's gradient norms over its visible rows, the change's norms."""
    from PIL import Image

    sc, tr = cfg["scene"], cfg["trainer"]
    vms, K = cameras(cfg, dev)
    params = {k: v.to(dev) for k, v in s0.items()}
    p0 = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator(device=dev).manual_seed(noise_seed)
    scale = scene_scale(vms)
    out = {"loss": [], "visible": [], "live_pairs": [], "entries": [],
           "image_ids": list(image_ids)}
    for j, (step, idx) in enumerate(zip(steps, image_ids)):
        path = os.path.join(data_dir, f"images_{sc['data_factor']}", f"img_{idx:03d}.png")
        gt = torch.as_tensor(np.array(Image.open(path).convert("RGB")), device=dev)
        gt = gt.to(torch.float32) / 255.0
        params, mu, nu, rec = ref_train.train_step(
            params, mu, nu, gt, vms[idx], K, step, gen, scale, max_steps=tr["max_steps"],
            refine_every=tr["refine_every"], refine_start=tr["refine_start_iter"],
            refine_stop=tr["refine_stop_iter"], noise_lr=tr["noise_lr"],
            opacity_reg=tr["opacity_reg"], scale_reg=tr["scale_reg"],
            ssim_lambda=tr["ssim_lambda"], dtype=dtype,
            rows=gt.shape[0] // 2 if half else None)
        out["loss"].append(rec["loss"])
        out["visible"].append(int(rec["visible"].sum()))
        out["live_pairs"].append(rec["live_pairs"])
        out["entries"].append(rec["entries"])
        if j == 0:
            vis = rec["visible"]
            out["grad"] = _norms({k: torch.where(vis.reshape((-1,) + (1,) * (g.dim() - 1)),
                                                 g, torch.zeros_like(g))
                                  for k, g in rec["grads"].items()})
    out["change"] = _norms({k: params[k] - p0[k] for k in p0})
    return out
