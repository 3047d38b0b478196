"""Traffic of kind ``train_2dgs``: the system's trainer (``Runner.train``)
training 2DGS (``Config(model_type="2dgs", normal_loss=True,
dist_loss=True)``: the surfel projection, kernels 5 and 6 behind autograd,
the depth map's normals, the normal-consistency and distortion terms)
under the DefaultStrategy past its ``refine_stop_iter``, on the scene of
``drivers/train.py`` from a state of surfels laid in its surfaces
(``scenes/surfels.py``), in whole periods.

Past the stop the strategy neither refines nor resets, so every step of
the window does the same work at the final size. Set-up, the checked
steps, the window and the traced run are the 3DGUT driver's
(``drivers/train_3dgut.py``'s ``_program_run``, run with this driver's
program; the 3DGS driver's helpers are imported): the stream is sized by
the plan of the surfel projection's footprints
(``tiling.footprint_plan``),
the tile capacity is the configuration's, and a step that drops an entry,
from the stream or from a tile, fails the run. The checked steps hold no
refine, so no relocation is compared. The reference is
``reference/train_2dgs.py``.

The first step's gradient is compared over the rows its view sees at
least ``EDGE_ON`` from edge-on (|cos| of the surfel's normal against the
ray to its centre, the reference's ``facing``). A surfel seen within a
fraction of a degree of edge-on has an ill-conditioned ray–plane
intersection: its gradient is orders of magnitude above the others', can
make up most of a leaf's norm, and two float32 implementations of the same
equations part there by percents (8% on one such row on an H100, 0.7% on
one on the CPU).
Those rows stay in the loss and in the change over the three steps, whose
Adam steps do not scale with the gradient.

The control and the planted faults run the reference in the system's
place: ``portbench/control.py`` runs the bfloat16 control and the half
batch; this module's ``main``, from the root of a checkout, runs those and the
faults of this cell:

    python3 -m portbench.drivers.train_2dgs --workload <cell> --seeds <n> [<n> ...]
        [--fault half|transposed|no_dist|no_normal]

(``transposed``: the ray transform read transposed; ``no_dist`` and
``no_normal``: the distortion or the normal-consistency term left out.)
Each seed's compared numbers, one JSON line each."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import types
from typing import Dict

import numpy as np
import torch

from portbench import check
from portbench import run as bench_run
from portbench.drivers import train_3dgut
from portbench.drivers.train import (
    _Checked,
    _norms,
    cameras,
    compare,
    scene_dir,
    scene_scale,
    train_views,
)
from portbench.reference import train_2dgs as ref_train
from portbench.scenes.surfels import trained_surfels
from portbench.work import counts_2dgs as counts

FAULTS = ("", "half", "transposed", "no_dist", "no_normal")
# |cos| below which a row's gradient is left out of the compared norms
EDGE_ON = 1e-2


def _program(cfg, state, seed, data_dir, device):
    from tdgs_torch.ops.projection_2dgs import fully_fused_projection_2dgs
    from tdgs_torch.ops.tiling import footprint_plan
    from tdgs_torch.strategy import DefaultStrategy
    from tdgs_torch.training.config import Config
    from tdgs_torch.training.trainer import Runner

    tr, sc, rc = cfg["trainer"], cfg["scene"], cfg["render"]
    n = cfg["state"]["n_gauss"]
    strategy = DefaultStrategy(refine_start_iter=tr["refine_start_iter"],
                               refine_stop_iter=tr["refine_stop_iter"],
                               reset_every=tr["reset_every"],
                               refine_every=tr["refine_every"])
    vms, K = cameras(cfg, device)
    # the stream as the render tiles it: by the surfel projection's footprints
    plans = []
    for i in range(len(vms)):
        with torch.no_grad():
            radii, means2d, _, _, _ = fully_fused_projection_2dgs(
                state["means"], state["quats"], torch.exp(state["scales"]), vms[i:i + 1],
                K[None], sc["width"], sc["height"])
        plans.append(footprint_plan(means2d, radii, sc["width"], sc["height"],
                                    max_tiles_per_gauss=rc["max_tiles_per_gauss"],
                                    headroom=rc["isect_headroom"]))
    demand = max(p["full_isect_demand"] for p in plans)
    plan = {"isect_capacity": -(-int(demand * rc["isect_headroom"]) // 4096) * 4096,
            "full_isect_demand": demand,
            "footprint_kmax": max(p["footprint_kmax"] for p in plans),
            "tile_capacity": rc["tile_capacity"]}
    result_dir = tempfile.mkdtemp(prefix="portbench-train-2dgs-")
    config = Config(
        data_dir=data_dir, data_factor=sc["data_factor"], result_dir=result_dir,
        test_every=sc["test_every"], normalize_world_space=False,
        max_steps=tr["max_steps"], eval_steps=[], save_steps=[], ply_steps=[],
        sh_degree=tr["sh_degree"], init_opa=tr["init_opa"], init_scale=tr["init_scale"],
        opacity_reg=tr["opacity_reg"], scale_reg=tr["scale_reg"],
        ssim_lambda=tr["ssim_lambda"], batch_size=tr["batch_size"],
        rasterizer=tr["rasterizer"], strategy=strategy, capacity=n, model_type="2dgs",
        normal_loss=True, normal_lambda=tr["normal_lambda"],
        normal_start_iter=tr["normal_start_iter"], dist_loss=True,
        dist_lambda=tr["dist_lambda"], dist_start_iter=tr["dist_start_iter"],
        tile_capacity=plan["tile_capacity"],
        isect_capacity=plan["isect_capacity"], isect_exact=True,
        max_tiles_per_gauss=rc["max_tiles_per_gauss"], seed=seed)
    runner = Runner(config, device=device)
    runner.splats = {k: v.clone() for k, v in state.items()}
    runner.capacity = n
    runner.opt_state = runner.optimizer.init(runner.splats)
    return runner, plan, result_dir


class _Unrefined(_Checked):
    """The 3DGS driver's checked steps with no refine step to record: past
    the stop the strategy does nothing."""

    def __init__(self, runner, s0, n_chain, refine_step, reloc_seed):
        del refine_step
        super().__init__(runner, s0, n_chain, None, reloc_seed)


def _row_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf's norm of each row, on the host: ``run`` takes the leaves'
    norms over the rows it compares."""
    return {k: v.reshape(v.shape[0], -1).double().norm(dim=-1).cpu() for k, v in tree.items()}


# the 3DGUT driver's set-up, checked steps, window and traced run, with
# this driver's program and checked steps in place of its own, and the
# first gradient kept by rows: its code run over a copy of its module's
# globals with these names bound anew. A name that function no longer
# reads fails here, at import, rather than leaving its own in place.
_REBOUND = {"_program": _program, "_Checked": _Unrefined, "_norms": _row_norms}
_unread = set(_REBOUND) - set(train_3dgut._program_run.__code__.co_names)
if _unread:
    raise ImportError(f"drivers/train_3dgut.py's _program_run no longer reads {sorted(_unread)}")
_program_run = types.FunctionType(train_3dgut._program_run.__code__,
                                  dict(vars(train_3dgut), **_REBOUND), "_program_run")


def _check_traffic(cfg: Dict, traffic: Dict) -> None:
    tr = cfg["trainer"]
    if traffic["check_start"] < tr["refine_stop_iter"]:
        raise ValueError(f"the checked steps from {traffic['check_start']} are not past the "
                         f"strategy's stop at {tr['refine_stop_iter']}")
    if traffic["check_start"] <= max(tr["normal_start_iter"], tr["dist_start_iter"]):
        raise ValueError("the checked steps start before both terms are on")


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False, fault: str = "") -> Dict:
    """One run of the cell; with ``control`` no system runs: the reference
    in bfloat16 takes its place on the same inputs, or with ``fault`` the
    reference with that fault (``FAULTS``)."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
    cfg, traffic = cell.config, cell.traffic
    _check_traffic(cfg, traffic)
    dev = torch.device(device)
    data_dir = scene_dir(cfg, dev)
    seeds = {"noise": (seed * 2654435761 + 97) % (1 << 63),
             "reloc": (seed * 40503 + 12345) % (1 << 63)}
    start = traffic["check_start"]
    n_chain = traffic["check_steps"]
    chain = list(range(start + 1, start + 1 + n_chain))
    out: Dict = {"attempted": 0, "failed": 0, "metrics": {}, "ctx": {}}
    state = trained_surfels(cfg["state"]["n_gauss"], seed, dev, cfg["state"])
    s0 = check.to_host(state)
    if control:
        del state
        ids = [int(x) for x in np.random.default_rng(seed).choice(train_views(cfg), n_chain)]
        prog = reference_steps(cfg, s0, data_dir, ids, chain, dev,
                               torch.float32 if fault else torch.bfloat16, fault=fault)
    else:
        prog = _program_run(cell, state, seed, seconds, trace, dev, t_start, data_dir, seeds,
                            out)
        del state
    refd = reference_steps(cfg, s0, data_dir, prog["image_ids"], chain, dev, torch.float32)
    rows = refd["compared_rows"]
    for side in (prog, refd):
        side["grad"] = {k: float(v[rows].norm()) for k, v in side["grad"].items()}
    print(f"gradient: {int(rows.sum())} rows compared, {int(refd['visible'][0]) - int(rows.sum())} "
          f"seen within {EDGE_ON} of edge-on left out", file=sys.stderr)
    values = compare(prog, refd)
    if not control:
        print(f"plan {out['ctx'].get('plan')}; steps with dropped entries {out['failed']}",
              file=sys.stderr)
    out["values"] = values
    out["compared"] = check.compared({k: values.get(k, 0.0) for k in cell.limits}, cell.limits)
    out["correct"] = check.verdict(out["compared"], out["failed"])
    sc = cfg["scene"]
    pixels = sc["width"] * sc["height"]
    n = cfg["state"]["n_gauss"]
    seen = list(zip(refd["visible"], refd["live_pairs"], refd["entries"]))
    work = [counts.train_step(n, v, lp, e, pixels) for v, lp, e in seen]
    comp = [(counts.composite(lp, e, v, pixels), counts.composite(lp, e, v, pixels, True))
            for v, lp, e in seen]
    out["ctx"]["work"] = {
        "step": {k: float(np.mean([w[k] for w in work])) for k in ("flops", "bytes")},
        "composite": {k: float(np.mean([a[k] + b[k] for a, b in comp]))
                      for k in ("flops", "bytes")},
    }
    return out


def reference_steps(cfg, s0, data_dir, image_ids, steps, dev, dtype, fault=""):
    """The reference's 2DGS steps from the same state → losses, the first
    step's gradient norms by row (zero where its view does not see the
    row), the rows it compares (seen, and at least ``EDGE_ON`` from
    edge-on), the change's norms."""
    from PIL import Image

    sc, tr = cfg["scene"], cfg["trainer"]
    vms, K = cameras(cfg, dev)
    params = {k: v.to(dev) for k, v in s0.items()}
    p0 = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    scale = scene_scale(vms)
    out = {"loss": [], "visible": [], "live_pairs": [], "entries": [],
           "image_ids": list(image_ids)}
    for j, (step, idx) in enumerate(zip(steps, image_ids)):
        path = os.path.join(data_dir, f"images_{sc['data_factor']}", f"img_{idx:03d}.png")
        gt = torch.as_tensor(np.array(Image.open(path).convert("RGB")), device=dev)
        gt = gt.to(torch.float32) / 255.0
        params, mu, nu, rec = ref_train.train_step(
            params, mu, nu, gt, vms[idx], K, step, scale, max_steps=tr["max_steps"],
            ssim_lambda=tr["ssim_lambda"],
            normal_lambda=0.0 if fault == "no_normal" else tr["normal_lambda"],
            normal_start=tr["normal_start_iter"],
            dist_lambda=0.0 if fault == "no_dist" else tr["dist_lambda"],
            dist_start=tr["dist_start_iter"], dtype=dtype, transposed=fault == "transposed",
            rows=gt.shape[0] // 2 if fault == "half" else None)
        out["loss"].append(rec["loss"])
        out["visible"].append(int(rec["visible"].sum()))
        out["live_pairs"].append(rec["live_pairs"])
        out["entries"].append(rec["entries"])
        if j == 0:
            vis = rec["visible"]
            out["grad"] = _row_norms({k: torch.where(vis.reshape((-1,) + (1,) * (g.dim() - 1)),
                                                     g, torch.zeros_like(g))
                                      for k, g in rec["grads"].items()})
            out["compared_rows"] = (vis & (rec["facing"] >= EDGE_ON)).cpu()
    out["change"] = _norms({k: params[k] - p0[k] for k in p0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default="", choices=FAULTS)
    args = ap.parse_args(argv)
    _, cell = bench_run.load_cell(args.workload)
    bench_run.settle()
    for seed in args.seeds:
        t0 = time.time()
        out = run(cell, seed, 0.0, False, args.device, t0, control=True, fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "correct": out["correct"], "values": out["values"],
                          "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
