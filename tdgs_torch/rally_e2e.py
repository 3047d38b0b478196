"""End-to-end domino rally on the port, as one command (port of
``examples/rally_e2e.py``):

  procedural multi-view domino dataset (COLMAP + instance masks)
    → 3DGS training with identity-vector segmentation (MCMC, "packed")
    → K-means clustering of the live rows' identity encodings
      (anchor-initialized)
    → PLY export/import round trip
    → rigid-body extraction, settled on the ground, the first domino pushed
    → the physics/render rally at 1920x1080 on a tiling plan derived from
      the trained scene's footprints, checked against a float64
      recomposition of the same stream

and prints one JSON summary with the JAX example's keys (the reference
oracle's ``reference_chain_psnr`` is left out: that oracle loads an
upstream checkout this repository does not have) plus the port's own:
``stage_s``, ``train_steps_per_s``, ``seg_steps``, ``cluster_sizes``,
``isect_plan``, ``exact_coverage_fallback``, ``device``. Unlike the
example, the K-means sees only the live rows (``cluster_live_rows``).

    python -m tdgs_torch.rally_e2e --json rally.json

Runs on the card unless ``--device cpu``. The rollout is timed as the JAX
example times its ``lax.scan``: the frames once to warm up, then the same
frames again from the same state, synchronised only at the end.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tdgs_torch._device import DeviceLike, resolve_device
from tdgs_torch.ops.sh import spherical_harmonics
from tdgs_torch.ops.tiling import derive_isect_plan
from tdgs_torch.physics import (
    PhysicsParams,
    extract_bodies_from_splats,
    initial_state,
    labels_to_body_ids,
    make_step_and_render,
    settle_on_ground,
)
from tdgs_torch.pipeline import GaussianModel
from tdgs_torch.rendering import rasterization
from tdgs_torch.segmentation import (
    apply_segmentation_head,
    kmeans_identity_encodings_background,
    load_cluster_groups,
    save_cluster_groups,
)
from tdgs_torch.strategy import MCMCStrategy
from tdgs_torch.training.config import Config
from tdgs_torch.training.trainer import Runner
from tdgs_torch.utils.golden import compose_reference_f64
from tdgs_torch.utils.ply import save_ply
from tdgs_torch.utils.test_data import DOMINO_BACKGROUND, make_domino_scene


def psnr_np(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rally_plan(splats, viewmat, K, width, height, device) -> tuple:
    """The rollout's tiling: ``derive_isect_plan`` with 30% headroom and a
    cap of 64 tiles a gaussian; where a footprint exceeds the cap, exact
    coverage at 1.3 times the full demand (rounded up to 4096) instead, as
    a capped plan would cut the biggest splats into bands. → (rasterization
    kwargs, the derived plan, whether it fell back to exact coverage)."""
    derived = derive_isect_plan(
        splats["means"], splats["quats"], torch.exp(splats["scales"]),
        torch.sigmoid(splats["opacities"]), viewmat[None], K[None], width, height,
        headroom=1.3, max_tiles_per_gauss=64, device=device)
    plan = dict(derived)
    full_demand = plan.pop("full_isect_demand")
    if plan.pop("footprint_kmax") > plan["max_tiles_per_gauss"]:
        return ({"isect_capacity": -(-int(full_demand * 1.3) // 4096) * 4096,
                 "isect_exact": True}, derived, True)
    return plan, derived, False


def golden_psnr(splats, sh, sh_degree, viewmat, K, width, height, background, plan,
                tile_capacity, device) -> float:
    """The frame through the production kernel against
    ``compose_reference_f64`` over the same projected stream (exact-depth
    order, as the float64 oracle sorts), in dB."""
    opac = torch.sigmoid(splats["opacities"])
    img, _, meta = rasterization(
        splats["means"], splats["quats"], torch.exp(splats["scales"]), opac, sh,
        viewmat[None], K[None], width, height, sh_degree=sh_degree,
        rasterizer="packed_inference", backgrounds=torch.full((1, 3), background, device=device),
        isect_exact_depth=True, tile_capacity=tile_capacity, device=device, **plan)
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    campos = -R.T @ t
    cols = torch.clamp(spherical_harmonics(sh_degree, splats["means"] - campos, sh) + 0.5,
                       min=0.0)
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    oracle = compose_reference_f64(
        host(meta["isect_offsets"]), host(meta["flatten_ids"]),
        host(meta["means2d"]).reshape(-1, 2), host(meta["conics"]).reshape(-1, 3),
        host(cols), host(opac), width, height, meta["tile_size"], meta["tile_width"],
        meta["tile_height"], background=np.full((3,), background),
        n_isects=meta["n_isects"])
    return psnr_np(np.clip(host(img[0]), 0, 1), np.clip(oracle, 0, 1))


def clustering_inputs(runner: Runner):
    """What the chain clusters, from a trained ``runner``: the identity
    maps and instance masks of four spread training views stacked
    (one view can hide the rear dominoes behind the front ones and starve
    their anchors of pixels), the head's features of every row and every
    row's opacity → (identity map, instance mask, features, opacities)."""
    n_views = len(runner.trainset)
    view_ids = sorted({0, n_views // 4, n_views // 2, 3 * n_views // 4})
    identity_map = np.concatenate([runner.render_identity_map(v) for v in view_ids], axis=0)
    instance_mask = np.concatenate(
        [np.asarray(runner.trainset[v]["instance_mask"]) for v in view_ids], axis=0)
    with torch.no_grad():
        feats = apply_segmentation_head(runner.seg_head,
                                        runner.splats["identity_encodings"])
    opac = torch.sigmoid(runner.splats["opacities"]).cpu().numpy()
    return identity_map, instance_mask, feats, opac


def cluster_live_rows(identity_map, instance_mask, feats, opacities,
                      min_opacity: float = 0.05, outlier_percentile: float = 95.0,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """``kmeans_identity_encodings_background`` over the rows whose opacity
    reaches ``min_opacity``; every other row is background (label −1).

    The JAX example clusters every row and drops the faint ones after. Its
    capacity's unused MCMC rows (about two thirds of the chain's 24k) share
    one encoding, so they pull one anchor's centroid onto it, and that
    domino's gaussians join a neighbour's cluster: the chain then finds a
    "cluster" of a few live rows where a domino should be."""
    live = np.flatnonzero(np.asarray(opacities) >= min_opacity)
    if isinstance(feats, torch.Tensor):
        feats = feats.detach().cpu().numpy()
    res = kmeans_identity_encodings_background(identity_map, instance_mask, feats[live],
                                               outlier_percentile=outlier_percentile,
                                               device=device)
    labels = np.full(len(opacities), -1, res["labels"].dtype)
    labels[live] = res["labels"]
    return {**res, "labels": labels}


def chain_config(data_dir: str, out_dir: str, steps: int = 2000, capacity: int = 24_000,
                 ckpt_every: int = 500):
    """The chain's training ``Config``: MCMC with the mcmc preset's
    regularizers, segmentation (identity_dim 16) from step min(500,
    steps/3), the CGC loss every 10 steps and the spatial regularizer every
    100, the physics frame kept (no world normalization)."""
    return Config(
        data_dir=data_dir, data_factor=1, result_dir=out_dir,
        normalize_world_space=False,  # keep the physics frame (z-up, ground z=0)
        max_steps=steps, eval_steps=[steps],
        save_steps=sorted(set(range(ckpt_every, steps, ckpt_every)) | {steps}),
        ply_steps=[], init_type="sfm",
        # the mcmc preset's hypers (examples/simple_trainer.py:1597-1618)
        init_opa=0.5, init_scale=0.1, opacity_reg=0.01, scale_reg=0.01,
        # composite onto the dataset's flat backdrop, or giant grey splats
        # explain the background and blow up the rally's tile working set
        background_color=(DOMINO_BACKGROUND,) * 3,
        # ground-truth splats are <= 0.1 world units across
        max_scale=0.15,
        sh_degree=3, sh_degree_interval=max(steps // 4, 1),
        strategy=MCMCStrategy(cap_max=capacity, refine_start_iter=min(300, steps // 4),
                              refine_stop_iter=max(steps - 200, 1), refine_every=100),
        capacity=capacity, with_segmentation=True, identity_dim=16,
        seg_start_iter=min(500, steps // 3), seg_loss_every=10, seg_spatial_every=100,
        tb_every=100,
    )


def run_chain(
    data_dir: str = "data/domino_synth",
    out_dir: str = "results/rally_e2e",
    steps: int = 2000,
    n_dominoes: int = 6,
    capacity: int = 24_000,
    n_images: int = 32,
    gauss_per_domino: int = 700,
    ground_gauss: int = 2500,
    data_width: int = 480,
    data_height: int = 360,
    sfm_points: int = 4000,
    frames: int = 90,
    fps: int = 30,
    physics_hz: int = 240,
    width: int = 1920,
    height: int = 1080,
    push: float = 5.0,
    ckpt_every: int = 500,
    skip_train: bool = False,
    gif: Optional[str] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """The five stages at the JAX example's defaults; returns the summary.
    ``gif``: a path to write the rally as a GIF (needs PIL), or None."""
    dev = resolve_device(device)
    t_wall0 = time.perf_counter()
    summary: Dict[str, Any] = {"steps": steps, "n_dominoes": n_dominoes}
    stage_s: Dict[str, float] = {}

    # ---- 1. dataset (procedural stand-in for the captured domino scene) ----
    t0 = time.perf_counter()
    if not os.path.isdir(os.path.join(data_dir, "sparse")):
        print(f"[1/5] generating domino dataset at {data_dir}", flush=True)
        make_domino_scene(data_dir, n_dominoes=n_dominoes, n_images=n_images,
                          width=data_width, height=data_height,
                          gauss_per_domino=gauss_per_domino, ground_gauss=ground_gauss,
                          sfm_points=sfm_points, device=dev)
    else:
        print(f"[1/5] dataset exists at {data_dir}", flush=True)
    stage_s["dataset"] = time.perf_counter() - t0

    # ---- 2. train with segmentation ----
    t0 = time.perf_counter()
    cfg = chain_config(data_dir, out_dir, steps, capacity, ckpt_every)
    runner = Runner(cfg, device=dev)
    have = sorted((int(os.path.basename(p)[5:-4]), p)
                  for p in glob.glob(os.path.join(out_dir, "ckpts", "ckpt_*.pkl")))
    start = 0
    train_s = 0.0
    if have:
        start, newest = have[-1]
        print(f"[2/5] resuming from {newest} (step {start})", flush=True)
        runner.load_checkpoint(newest)
    if skip_train or start >= steps:
        val = runner.eval(steps)
    else:
        print(f"[2/5] training steps {start + 1}..{steps} on {dev}", flush=True)
        _sync(dev)
        t_train = time.perf_counter()
        runner.train(start_step=start)
        _sync(dev)
        train_s = time.perf_counter() - t_train
        with open(os.path.join(out_dir, "stats", f"val_step{steps}.json")) as f:
            val = json.load(f)
    print(f"      val PSNR {val['psnr']:.2f}  SSIM {val['ssim']:.3f}  "
          f"num_GS {val['num_GS']}", flush=True)
    summary.update(train_psnr=val["psnr"], train_ssim=val["ssim"],
                   num_gaussians=val["num_GS"],
                   train_steps_per_s=(steps - start) / train_s if train_s else None,
                   seg_steps=runner.seg_steps)
    stage_s["train"] = time.perf_counter() - t0

    # ---- 3. cluster identity encodings (anchor K-means + bg outliers) ----
    t0 = time.perf_counter()
    print("[3/5] clustering identity encodings", flush=True)
    identity_map, instance_mask, feats, opac = clustering_inputs(runner)
    res = cluster_live_rows(identity_map, instance_mask, feats, opac, device=dev)
    labels = res["labels"]
    clusters_path = os.path.join(out_dir, "cluster_groups.npz")
    save_cluster_groups(clusters_path, res)
    sizes = [int((labels == k).sum()) for k in np.unique(labels) if k >= 0]
    print(f"      {len(sizes)} clusters (expected {n_dominoes}) of {sizes} gaussians; "
          f"{(labels < 0).mean() * 100:.1f}% background", flush=True)
    summary["clusters_found"] = len(sizes)
    summary["cluster_sizes"] = sizes
    summary["clusters_expected"] = n_dominoes
    stage_s["cluster"] = time.perf_counter() - t0

    # ---- 4. PLY round trip ----
    t0 = time.perf_counter()
    print("[4/5] PLY export/import round trip", flush=True)
    ply_path = os.path.join(out_dir, "scene.ply")
    sp = {k: v.detach().cpu().numpy() for k, v in runner.splats.items()}
    save_ply(ply_path, sp["means"], sp["scales"], sp["quats"], sp["opacities"],
             sp["sh0"], sp["shN"])
    splats = GaussianModel(sh_degree=cfg.sh_degree, device=dev).load_splats_from_ply(ply_path)
    groups = load_cluster_groups(clusters_path)
    stage_s["ply"] = time.perf_counter() - t0

    # ---- 5. rally: bodies + step/render ----
    t0 = time.perf_counter()
    print("[5/5] rigid-body rally", flush=True)
    n = splats["means"].shape[0]
    lab = np.full(n, -1, np.int32)
    for k, idx in groups.items():
        if k != "background":
            lab[idx] = int(k)
    host = {k: v.cpu().numpy() for k, v in splats.items()}
    bodies, body_groups = extract_bodies_from_splats(
        host["means"], host["quats"], np.exp(host["scales"]),
        1.0 / (1.0 + np.exp(-host["opacities"])), lab, device=dev)
    bodies = settle_on_ground(bodies)
    body_ids = torch.as_tensor(labels_to_body_ids(lab, body_groups), device=dev)
    n_bodies = int(bodies.mass.shape[0])
    print(f"      {n_bodies} rigid bodies", flush=True)
    summary["n_bodies"] = n_bodies

    # camera: the first training view, scaled to the rally resolution
    d = runner.trainset[0]
    W, H = width, height
    src_h, src_w = d["image"].shape[:2]
    K = np.asarray(d["K"], np.float32).copy()
    K[0] *= W / src_w
    K[1] *= H / src_h
    K = torch.as_tensor(K, device=dev)
    viewmat = torch.as_tensor(np.asarray(d["viewmat"], np.float32), device=dev)
    sh = torch.cat([splats["sh0"], splats["shN"]], dim=-2)
    scales_act, opac_act = torch.exp(splats["scales"]), torch.sigmoid(splats["opacities"])
    bkgd = torch.full((1, 3), DOMINO_BACKGROUND, device=dev)
    tile_capacity = 2048

    # the tiling plan, once per scene (it waits for the device)
    plan, derived, fallback = rally_plan(splats, viewmat, K, W, H, dev)
    print(f"      isect plan {derived}" + (
        f" → exact coverage, capacity {plan['isect_capacity']}" if fallback else ""),
        flush=True)
    summary["isect_plan"] = {k: v for k, v in plan.items()}
    summary["isect_plan_derived"] = derived
    summary["exact_coverage_fallback"] = fallback

    def render_fn(m, q):
        img, alpha, _ = rasterization(
            m, q, scales_act, opac_act, sh, viewmat[None], K[None], W, H,
            sh_degree=cfg.sh_degree, rasterizer="packed_inference", backgrounds=bkgd,
            tile_capacity=tile_capacity, device=dev, **plan)
        return img, alpha

    substeps = max(physics_hz // fps, 1)
    step_and_render = make_step_and_render(
        {"means": splats["means"], "quats": splats["quats"]}, body_ids, bodies, render_fn,
        params=PhysicsParams(dt=1.0 / physics_hz), substeps=substeps)
    state0 = initial_state(bodies)
    # push the body with the smallest COM x: the head of the row
    first = int(torch.argmin(bodies.com0[:, 0]))
    w = state0.w.clone()
    w[first, 1] = push
    state = state0._replace(w=w)

    # golden check of the pre-push frame
    t_gold = time.perf_counter()
    gold = golden_psnr(splats, sh, cfg.sh_degree, viewmat, K, W, H, DOMINO_BACKGROUND, plan,
                       tile_capacity, dev)
    summary["golden_s"] = time.perf_counter() - t_gold
    print(f"      kernel-vs-oracle PSNR {gold:.2f} dB ({W}x{H}, trained scene)", flush=True)
    summary["kernel_vs_oracle_psnr"] = round(gold, 2)

    def rollout(st):
        means = []
        for _ in range(frames):
            st, img, _ = step_and_render(st)
            means.append(img.mean())
        return st, torch.stack(means)

    _sync(dev)
    t_first = time.perf_counter()
    rollout(state)
    _sync(dev)
    compile_s = time.perf_counter() - t_first
    t1 = time.perf_counter()
    state_end, frame_means = rollout(state)
    _sync(dev)
    steady = time.perf_counter() - t1
    rally_fps = frames / steady
    rally_hz = rally_fps * substeps
    print(f"      rally: {rally_fps:.1f} fps @ {W}x{H} ({rally_hz:.0f} Hz physics; "
          f"warm-up rollout {compile_s:.1f}s)", flush=True)
    summary.update({
        "rally_fps": round(rally_fps, 2),
        "rally_physics_hz": round(rally_hz, 1),
        "frames": frames, "width": W, "height": H,
        "compile_s": round(compile_s, 1),
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "all_frames_finite": bool(torch.isfinite(frame_means).all()),
    })
    # the push must topple dominoes
    moved = float((state_end.x - state0.x).abs().max())
    summary["max_body_displacement"] = round(moved, 4)

    if gif:
        from PIL import Image

        st, small = state, []
        for _ in range(frames):
            st, img, _ = step_and_render(st)
            fr = (torch.clamp(img[0, ..., :3], 0, 1) * 255).to(torch.uint8).cpu().numpy()
            small.append(Image.fromarray(fr).resize((W // 2, H // 2)))
        small[0].save(gif, save_all=True, append_images=small[1:],
                      duration=int(1000 / fps), loop=0)
        print(f"      saved {gif}", flush=True)
    stage_s["rally"] = time.perf_counter() - t0

    summary["stage_s"] = stage_s
    summary["wall_s"] = round(time.perf_counter() - t_wall0, 1)
    summary["north_star"] = {
        "render_fps_target": 30.0,
        "render_fps_ok": rally_fps >= 30.0,
        "physics_hz_target": 240.0,
        "physics_hz_ok": rally_hz >= 240.0,
        "psnr_target": 40.0,
        "psnr_ok": gold >= 40.0,
    }
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default="data/domino_synth")
    ap.add_argument("--out-dir", default="results/rally_e2e")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--n-dominoes", type=int, default=6)
    ap.add_argument("--capacity", type=int, default=24_000)
    ap.add_argument("--n-images", type=int, default=32)
    ap.add_argument("--gauss-per-domino", type=int, default=700)
    ap.add_argument("--ground-gauss", type=int, default=2500)
    ap.add_argument("--data-width", type=int, default=480)
    ap.add_argument("--data-height", type=int, default=360)
    ap.add_argument("--sfm-points", type=int, default=4000)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--physics-hz", type=int, default=240)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--push", type=float, default=5.0,
                    help="initial angular velocity (rad/s) of the first domino")
    ap.add_argument("--ckpt-every", type=int, default=500,
                    help="mid-run checkpoint cadence; a run resumes from the newest")
    ap.add_argument("--skip-train", action="store_true",
                    help="evaluate the newest checkpoint in --out-dir instead of training")
    ap.add_argument("--gif", default=None,
                    help="write the rally here (default OUT_DIR/rally.gif; '' for none)")
    ap.add_argument("--json", default=None, help="write the summary JSON here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    gif = os.path.join(args.out_dir, "rally.gif") if args.gif is None else (args.gif or None)
    summary = run_chain(
        data_dir=args.data_dir, out_dir=args.out_dir, steps=args.steps,
        n_dominoes=args.n_dominoes, capacity=args.capacity, n_images=args.n_images,
        gauss_per_domino=args.gauss_per_domino, ground_gauss=args.ground_gauss,
        data_width=args.data_width, data_height=args.data_height,
        sfm_points=args.sfm_points, frames=args.frames, fps=args.fps,
        physics_hz=args.physics_hz, width=args.width, height=args.height, push=args.push,
        ckpt_every=args.ckpt_every, skip_train=args.skip_train, gif=gif,
        device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.json}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
