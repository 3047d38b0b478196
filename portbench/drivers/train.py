"""Traffic of kind ``train``: the system's trainer (``Runner.train``) on a
scene laid out as a COLMAP capture, from a trained state, in whole refine
periods.

Set-up writes the scene once into the checkout's cache (the ground truth
rendered by the reference), builds the Runner, puts the seed's trained
state of the configuration's size into it, and drives the checked steps
through ``Runner.train`` itself: they start one step before a refine, so
they hold the position noise, a relocation and a step after it. The
window then runs ``Runner.train`` period after period until ``--seconds``
have passed. The untraced run traces the device over the window and
reports its busy time a step; the traced run reports the steps completed
over the time they took, and traces a few steps after the window.
After the window the reference follows the checked steps from the same
state, images, cameras and generator seed, and compares each step's loss,
the gradient Adam received in the first (from the system's moments after
it) and the parameters' change over the three, by the worst leaf."""

from __future__ import annotations

import gc
import hashlib
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from portbench import check, harness
from portbench.reference import render as ref_render
from portbench.reference import train as ref_train
from portbench.scenes import rich
from portbench.scenes.state import trained_state
from portbench.work import counts

B1 = 0.9


def scene_dir(cfg: Dict, device) -> str:
    """The scene written as a COLMAP capture at ``data_factor``, once per
    checkout: the ground truth rendered by the reference, PNG under
    ``images_<factor>``. Later runs find it by the scene's parameters."""
    sc = cfg["scene"]
    key = hashlib.sha1(json.dumps(sc, sort_keys=True).encode()).hexdigest()[:12]
    root = os.path.join(harness.CACHE, f"{cfg['name']}-{key}")
    if os.path.exists(os.path.join(root, "done")):
        return root
    from PIL import Image

    tmp = root + ".part"
    shutil.rmtree(tmp, ignore_errors=True)
    W, H, f4 = sc["width"], sc["height"], sc["data_factor"]
    surf = rich.Surfaces(seed=sc["seed"], extent=sc["extent"])
    gt = rich.ground_truth(surf, sc["n_gt"], sc["seed"])
    vms, K = rich.cameras(sc["n_images"], W, H)
    names = [f"img_{i:03d}.png" for i in range(sc["n_images"])]
    img_dir = os.path.join(tmp, f"images_{f4}")
    os.makedirs(img_dir)
    dev = torch.device(device)
    t = {k: torch.as_tensor(v, device=dev) for k, v in gt.items()}
    sh = torch.zeros((len(gt["means"]), 16, 3), device=dev)
    sh[:, 0] = (t["colors"] - 0.5) / ref_render.SH_C0
    bg = torch.full((3,), sc["background"], device=dev)
    for i in range(sc["n_images"]):
        rgb, _, _ = ref_render.render(t["means"], t["quats"], t["scales"], t["opacities"], sh,
                                      torch.as_tensor(vms[i], device=dev),
                                      torch.as_tensor(K, device=dev), W, H, background=bg,
                                      sh_degree=0)
        img = (rgb.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(img).save(os.path.join(img_dir, names[i]), compress_level=1)
    rng = np.random.default_rng(sc["seed"])
    sel = rng.choice(len(gt["means"]), size=sc["sfm_points"], replace=False)
    rich.write_colmap(os.path.join(tmp, "sparse", "0"), W * f4, H * f4, float(K[0, 0]) * f4,
                      vms, names, gt["means"][sel], gt["colors"][sel])
    open(os.path.join(tmp, "done"), "w").close()
    shutil.rmtree(root, ignore_errors=True)
    os.rename(tmp, root)
    return root


def cameras(cfg: Dict, device):
    sc = cfg["scene"]
    vms, K = rich.cameras(sc["n_images"], sc["width"], sc["height"])
    return torch.as_tensor(vms, device=device), torch.as_tensor(K, device=device)


def train_views(cfg: Dict):
    """The views trained on, in order: every one but each ``test_every``-th
    (gsplat's split)."""
    return [i for i in range(cfg["scene"]["n_images"]) if i % cfg["scene"]["test_every"] != 0]


def scene_scale(viewmats: torch.Tensor) -> float:
    """1.1 × 1.1 × the largest camera distance from the cameras' mean: the
    system's convention (its parser's 1.1, then its trainer's), which
    upstream gsplat applies once."""
    R, t = viewmats[:, :3, :3], viewmats[:, :3, 3]
    centres = -(R.transpose(1, 2) @ t[..., None])[..., 0]
    return float((centres - centres.mean(0)).norm(dim=-1).max()) * 1.1 * 1.1


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


class _Checked:
    """Wraps the Runner's step and strategy for the checked steps: each
    chained step's loss, the first one's moments, the state after the
    chain, and the refine step's state around its strategy call, taken
    after the generator is seeded with the benchmark's own seed; then, for
    every step, whether the stream dropped entries."""

    def __init__(self, runner, s0, n_chain, refine_step, reloc_seed):
        self.losses, self.dropped, self.mu1 = [], 0, None
        self.change, self.reloc = None, {}
        self.record = True
        inner_step, inner_strategy = runner.train_step, runner.strategy_post_backward

        def step(*args, **kwargs):
            if self.record and len(self.losses) == n_chain and self.change is None:
                self.change = _norms({k: runner.splats[k] - s0[k] for k in s0})
            loss, aux = inner_step(*args, **kwargs)
            self.dropped += int(aux["n_dropped"] > 0)
            if self.record and len(self.losses) < n_chain:
                self.losses.append(loss)
                if self.mu1 is None:
                    self.mu1 = {k: v.clone() for k, v in runner.opt_state["mu"].items()}
            return loss, aux

        def strategy(step_no, info, lr):
            if not (self.record and step_no == refine_step):
                return inner_strategy(step_no, info, lr)
            from tdgs_torch.strategy import mcmc

            draw = mcmc.mcmc_sample_sources

            def sources(*args, **kwargs):
                out = draw(*args, **kwargs)
                self.reloc["sources"] = None if out is None else out.cpu()
                return out

            runner.generator.manual_seed(reloc_seed)
            self.reloc["pre"] = check.to_host({"params": runner.splats, **runner.opt_state})
            self.reloc["lr"] = lr
            mcmc.mcmc_sample_sources = sources
            try:
                inner_strategy(step_no, info, lr)
            finally:
                mcmc.mcmc_sample_sources = draw
            self.reloc["post"] = check.to_host({"params": runner.splats, **runner.opt_state})

        runner.train_step = step
        runner.strategy_post_backward = strategy


def _program(cfg, state, seed, data_dir, device):
    from tdgs_torch.ops.tiling import derive_isect_plan
    from tdgs_torch.strategy import MCMCStrategy
    from tdgs_torch.training.config import Config
    from tdgs_torch.training.trainer import Runner

    tr = cfg["trainer"]
    n = cfg["state"]["n_gauss"]
    strategy = MCMCStrategy(cap_max=tr["cap_max"], noise_lr=tr["noise_lr"],
                            refine_start_iter=tr["refine_start_iter"],
                            refine_stop_iter=tr["refine_stop_iter"],
                            refine_every=tr["refine_every"])
    vms, K = cameras(cfg, device)
    sc, rc = cfg["scene"], cfg["render"]
    plans = [derive_isect_plan(state["means"], state["quats"], torch.exp(state["scales"]),
                               torch.sigmoid(state["opacities"]), vms[i:i + 1], K[None],
                               sc["width"], sc["height"],
                               max_tiles_per_gauss=rc["max_tiles_per_gauss"],
                               headroom=rc["isect_headroom"], device=device)
             for i in range(len(vms))]
    # every covered tile, as gsplat covers them: the stream is sized by the
    # plan's full demand of the fullest view, with the configured headroom;
    # the tile capacity is the configuration's (no tile is cut: a step that
    # drops an entry fails)
    demand = max(p["full_isect_demand"] for p in plans)
    plan = {"isect_capacity": -(-int(demand * rc["isect_headroom"]) // 4096) * 4096,
            "full_isect_demand": demand,
            "footprint_kmax": max(p["footprint_kmax"] for p in plans),
            "tile_capacity": rc["tile_capacity"]}
    result_dir = tempfile.mkdtemp(prefix="portbench-train-")
    config = Config(
        data_dir=data_dir, data_factor=sc["data_factor"], result_dir=result_dir,
        test_every=sc["test_every"], normalize_world_space=False,
        max_steps=tr["max_steps"], eval_steps=[], save_steps=[], ply_steps=[],
        sh_degree=tr["sh_degree"], init_opa=tr["init_opa"], init_scale=tr["init_scale"],
        opacity_reg=tr["opacity_reg"], scale_reg=tr["scale_reg"],
        ssim_lambda=tr["ssim_lambda"], batch_size=tr["batch_size"],
        rasterizer=tr["rasterizer"], strategy=strategy, capacity=n,
        tile_capacity=plan["tile_capacity"],
        isect_capacity=plan["isect_capacity"], isect_exact=True,
        max_tiles_per_gauss=rc["max_tiles_per_gauss"], seed=seed)
    runner = Runner(config, device=device)
    runner.splats = {k: v.clone() for k, v in state.items()}
    runner.capacity = n
    runner.opt_state = runner.optimizer.init(runner.splats)
    runner.strategy_state = dict(runner.strategy_state, n_alive=n)
    return runner, plan, result_dir


def _train(runner, start: int, n_steps: int) -> int:
    runner.cfg.max_steps = start + n_steps
    runner.train(start_step=start)
    return start + n_steps


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


def draw_z(opacities: torch.Tensor, sources: torch.Tensor, min_opacity: float = 0.005):
    """How far the drawn sources keep to MCMC's law, a draw with
    replacement of the live rows (opacity above ``min_opacity``) with
    probability ∝ opacity: |their mean opacity − Σo²/Σo| in standard errors
    of that mean under the law (σ² = Σo³/Σo − (Σo²/Σo)²). Sound draws read
    a standard normal's size; inf where a source is not a live row."""
    op = torch.sigmoid(opacities).double()
    live = op > min_opacity
    if not bool(live[sources].all()):
        return float("inf")
    w = op[live]
    law = float((w * w).sum() / w.sum())
    var = float((w ** 3).sum() / w.sum()) - law * law
    return abs(float(op[sources].mean()) - law) / math.sqrt(var / sources.numel())


def relocation_gap(reloc, reloc_seed, cfg, dev):
    """The refine step's strategy from the system's own state before it and
    its own draw of the sources: the reference's relocation and noise with
    the same seed, against the system's state after it (the worst leaf's
    gap of the change's norms over params and moments); and the draw held
    to its law by ``draw_z``. → (relocation gap, draw z, worst leaf)."""
    if "post" not in reloc or reloc.get("sources") is None:
        return float("inf"), float("inf"), None
    tr = cfg["trainer"]
    pre = {k: {n: t.to(dev) for n, t in v.items()} for k, v in reloc["pre"].items()}
    gen = torch.Generator(device=dev).manual_seed(reloc_seed)
    with torch.no_grad():
        src = reloc["sources"].to(dev)
        z = draw_z(pre["params"]["opacities"], src)
        params, mu, nu, _ = ref_train.relocate(pre["params"], pre["mu"], pre["nu"], gen,
                                               sources=src)
        noise = torch.randn(params["means"].shape, generator=gen, device=dev)
        params = ref_train.position_noise(params, noise, reloc["lr"] * tr["noise_lr"])
    prog_d, ref_d = {}, {}
    for name, ref_tree in (("params", params), ("mu", mu), ("nu", nu)):
        for k, v in ref_tree.items():
            ref_d[f"{name}.{k}"] = float((v - pre[name][k]).double().norm())
            prog_d[f"{name}.{k}"] = float(
                (reloc["post"][name][k].to(dev) - pre[name][k]).double().norm())
    post = reloc["post"]["params"]["means"].to(dev)
    moved = [int((m != pre["params"]["means"]).any(-1).sum()) for m in (post, params["means"])]
    apart = int(((post - params["means"]).abs() > 1e-4).any(-1).sum())
    print(f"relocation: rows moved {moved[0]} against {moved[1]}, rows apart {apart}",
          file=sys.stderr)
    gap, leaf = check.leaf_norm_gap(prog_d, ref_d)
    return gap, z, leaf


def _program_run(cell, state, seed, seconds, trace, dev, t_start, data_dir, seeds, out):
    """Set-up from ``state``, the checked steps and the window of the
    system → its readings of the checked steps; the run's numbers go into
    ``out``."""
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
    # set-up's objects leave the collector's generations: the window's
    # collections walk the window's own objects only
    gc.collect()
    gc.freeze()
    # the untraced run's window runs under the device's tracer: its busy
    # time a step is the end-to-end number; the traced run times the host
    # without it, and traces its own steps after the window
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
        n_tr = traffic["trace_steps"]
        tr = harness.profile(lambda: _train(runner, step, n_tr), dev)
        out["ctx"].update(trace=tr, traced_units=n_tr)
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
    """The reference's steps from the same state → losses, the first
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


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The worst step's relative loss gap, and the worst leaf's gap of the
    first gradient's and of the change's norms (leaves whose reference
    gradient is nought to rounding left out of the change)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog["loss"], ref["loss"]))
    grad_gap, g_leaf = check.leaf_norm_gap(prog["grad"], ref["grad"])
    skip = check.nought_leaves(ref["grad"])
    change_gap, c_leaf = check.leaf_norm_gap(prog["change"], ref["change"], skip=skip)
    print(f"losses {prog['loss']} against {ref['loss']}; worst leaves: gradient {g_leaf}, "
          f"change {c_leaf}; left out as nought {skip}", file=sys.stderr)
    if len(prog["loss"]) != len(ref["loss"]):
        loss_gap = math.inf
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
