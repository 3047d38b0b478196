"""Per-rank bodies of the sharded path's checks, run on a world by
``parallel.launch.run``: each makes its inputs from a seed with numpy (the
same global arrays on every rank), runs the port's collectives or sharded
renders on its block, and returns numpy arrays that the caller holds
against the JAX package, the single-rank render or the card. They live in
the package because a spawned rank imports its function by module.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tdgs_torch._device import DeviceLike
from tdgs_torch.parallel import comm
from tdgs_torch.parallel.mesh import make_mesh

# (split_axis, concat_axis) of the all_to_all gradient cases, on a block
# [4, 2·D, 3] of a global [4·D, 2·D, 3]
A2A_AXES = ((0, 0), (1, 0), (0, 1), (1, 2))


def comm_inputs(D: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The global inputs and cotangent weights of ``comm_case`` (numpy)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4 * D, 2 * D, 3)).astype(np.float32)
    out = {"x": x, "w_gather": rng.normal(size=(D, 4 * D, 2 * D, 3)).astype(np.float32),
           "w_reduce": rng.normal(size=(D, 4, 2 * D, 3)).astype(np.float32)}
    for s, c in A2A_AXES:
        shape = [4, 2 * D, 3]
        shape[s] //= D
        shape[c] *= D
        out[f"w_a2a_{s}{c}"] = rng.normal(size=[D] + shape).astype(np.float32)
    return out


def comm_case(device: DeviceLike = None, seed: int = 0) -> Dict[str, np.ndarray]:
    """The four cases of the JAX package's ``tests/test_comm.py`` and the
    gradient of Σ_ranks <out, w> through each differentiable collective,
    w.r.t. this rank's block of ``x``."""
    mesh = make_mesh(device=device)
    D, r, dev = mesh.world, mesh.rank, mesh.device
    out: Dict[str, np.ndarray] = {}
    x = torch.arange(D * 2, dtype=torch.float32, device=dev).reshape(D * 2, 1)
    out["gather"] = comm.all_gather(x[2 * r:2 * r + 2]).cpu().numpy()
    blocks = torch.arange(D * D, dtype=torch.float32, device=dev).reshape(D * D, 1)
    out["a2a"] = comm.all_to_all(blocks[D * r:D * r + D], split_axis=0,
                                 concat_axis=0).cpu().numpy()
    ones = torch.ones((1,), device=dev)
    out["reduce_rank_world"] = np.array(
        [float(comm.all_reduce_sum(ones.sum())), comm.world_rank(), comm.world_size()],
        np.float32)
    a = torch.arange(D, dtype=torch.float32, device=dev).reshape(D, 1)
    b = torch.arange(D * 2, dtype=torch.float32, device=dev).reshape(D * 2, 1)
    ga, gb = comm.all_gather_tensor_list([a[r:r + 1], b[2 * r:2 * r + 2]])
    out["list_a"], out["list_b"] = ga.cpu().numpy(), gb.cpu().numpy()
    la, lb = comm.all_to_all_tensor_list([blocks[D * r:D * r + D], b + 100 * r])
    out["list_a2a_blocks"], out["list_a2a_b"] = la.cpu().numpy(), lb.cpu().numpy()

    inputs = comm_inputs(D, seed)
    x = torch.as_tensor(inputs["x"][4 * r:4 * r + 4], device=dev).requires_grad_(True)

    def grad_of(y, w):
        loss = (y * torch.as_tensor(w[r], device=dev)).sum()
        return torch.autograd.grad(loss, x)[0].cpu().numpy()

    out["grad_gather"] = grad_of(comm.all_gather(x), inputs["w_gather"])
    out["grad_reduce"] = grad_of(comm.all_reduce_sum(x), inputs["w_reduce"])
    for s, c in A2A_AXES:
        y = comm.all_to_all(x, split_axis=s, concat_axis=c)
        out[f"a2a_{s}{c}"] = y.detach().cpu().numpy()
        out[f"grad_a2a_{s}{c}"] = grad_of(y, inputs[f"w_a2a_{s}{c}"])
    return out


# ---------------------------------------------------------------------------
# the sharded renders against the single-rank render of the same cameras
# ---------------------------------------------------------------------------

# name → options: kind ("3dgs", "2dgs", "eval3d", "replicated"), rasterizer,
# render_mode, grads, and the inputs' variants
RENDER_CASES = {
    "packed": dict(kind="3dgs", rasterizer="packed", render_mode="RGB+ED", backgrounds=True,
                   offset_tap=True),
    "packed_inference": dict(kind="3dgs", rasterizer="packed_inference", render_mode="RGB",
                             grads=False, antialiased=True, backgrounds=True),
    "jax": dict(kind="3dgs", rasterizer="jax", render_mode="RGB+D", offset_tap=True),
    "depth_only": dict(kind="3dgs", rasterizer="packed", render_mode="ED", backgrounds=True),
    "pallas": dict(kind="3dgs", rasterizer="pallas", render_mode="RGB"),
    "absgrad": dict(kind="3dgs", rasterizer="packed", render_mode="RGB", offset_tap=True,
                    abs_tap=True),
    "app_colors": dict(kind="3dgs", rasterizer="packed", render_mode="RGB",
                       per_camera_colors=True),
    "blind_rank": dict(kind="3dgs", rasterizer="packed", render_mode="RGB", blind=True,
                       offset_tap=True),
    "2dgs": dict(kind="2dgs", rasterizer="packed", render_mode="RGB+ED", distloss=True,
                 offset_tap=True, backgrounds=True),
    "eval3d": dict(kind="eval3d", render_mode="RGB+ED", backgrounds=True),
    "replicated": dict(kind="replicated", rasterizer="packed_inference", render_mode="RGB",
                       grads=False),
}
# the 2-D ("frame", "gauss") mesh on four ranks
MESH2D_CASES = {
    "mesh2d": dict(kind="3dgs", rasterizer="packed", render_mode="RGB", offset_tap=True),
}
SCENE = dict(N=48, width=48, height=32, tile_capacity=256, max_tiles_per_gauss=16,
             isect_capacity=1 << 14, sh_degree=1)


def render_scene(C: int, seed: int = 0, blind: bool = False) -> Dict[str, np.ndarray]:
    """The global inputs of a render case (numpy): N gaussians around z = 6,
    SH degree 1 (and per-camera colours), C cameras sliding along x, the
    last one turned away with ``blind``; cotangent weights for the outputs."""
    N, W, H = SCENE["N"], SCENE["width"], SCENE["height"]
    rng = np.random.default_rng(seed)
    s = {
        "means": (rng.normal(size=(N, 3)) * 1.5 + [0, 0, 6.0]).astype(np.float32),
        "quats": rng.normal(size=(N, 4)).astype(np.float32),
        "scales": rng.uniform(0.08, 0.4, size=(N, 3)).astype(np.float32),
        "opacities": rng.uniform(0.3, 1.0, size=(N,)).astype(np.float32),
        "sh": (rng.normal(size=(N, 4, 3)) * 0.3).astype(np.float32),
        "colors_cam": rng.uniform(0.0, 1.0, size=(C, N, 3)).astype(np.float32),
        "backgrounds": rng.uniform(0.0, 1.0, size=(C, 3)).astype(np.float32),
    }
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, 0, 3] = np.linspace(-0.5, 0.5, C)
    viewmats[:, 1, 3] = np.linspace(0.2, -0.2, C)
    if blind:
        viewmats[-1, :3, :3] = np.diag([-1.0, 1.0, -1.0])  # every gaussian behind it
    s["viewmats"] = viewmats
    s["Ks"] = np.tile(np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32),
                      (C, 1, 1))
    s["w_img"] = rng.normal(size=(C, H, W, 8)).astype(np.float32)
    s["w_alpha"] = rng.normal(size=(C, H, W, 1)).astype(np.float32)
    s["w_normals"] = rng.normal(size=(C, H, W, 3)).astype(np.float32)
    s["w_distort"] = rng.normal(size=(C, H, W, 1)).astype(np.float32)
    return s


def _loss(outs, w, cams):
    """Σ <output, weight> over the outputs of a render (the cotangents)."""
    img, alpha = outs[0], outs[1]
    loss = (img * w["w_img"][cams][..., :img.shape[-1]]).sum()
    loss = loss + (alpha * w["w_alpha"][cams]).sum()
    if len(outs) > 2:
        loss = loss + (outs[2] * w["w_normals"][cams]).sum()
        loss = loss + (outs[3] * w["w_distort"][cams]).sum()
    return loss


def _grads(outs, w, cams, leaves):
    """Gradients of ``_loss`` w.r.t. each leaf (zeros where unused: the
    colours of a depth-only render)."""
    vs = list(leaves.values())
    gs = torch.autograd.grad(_loss(outs, w, cams), vs, allow_unused=True)
    return [torch.zeros_like(v) if g is None else g for g, v in zip(gs, vs)]


def render_kw(spec: Dict) -> Dict:
    """The keywords a case renders with, alike for the port's sharded and
    single-rank calls and the JAX package's sharded call."""
    kw = dict(sh_degree=None if spec.get("per_camera_colors") else SCENE["sh_degree"],
              tile_capacity=SCENE["tile_capacity"],
              max_tiles_per_gauss=SCENE["max_tiles_per_gauss"])
    if spec["kind"] != "eval3d" and spec.get("rasterizer") in ("jax", "pallas"):
        kw["isect_capacity"] = SCENE["isect_capacity"]
    if spec["kind"] in ("3dgs", "replicated", "2dgs"):
        kw["rasterizer"] = spec["rasterizer"]
    kw["render_mode"] = spec["render_mode"]
    if spec["kind"] == "2dgs":
        kw["distloss"] = spec.get("distloss", False)
    if spec.get("antialiased"):
        kw["rasterize_mode"] = "antialiased"
    return kw


def render_case(spec: Dict, mesh, seed: int = 0) -> Dict[str, np.ndarray]:
    """One case on this rank: the sharded render of its cameras from its
    gaussian block (outputs, pre-exchange meta, gradients of the weighted
    outputs w.r.t. its leaves), and the port's single-rank render of the
    same cameras from every gaussian (``single_*``: outputs, and the
    gradients summed over the ranks, cut to this rank's block)."""
    from tdgs_torch.parallel import sharded_render as SR
    from tdgs_torch.rendering import rasterization, rasterization_2dgs
    from tdgs_torch.utils.depth import rotate

    dev = mesh.device
    frame = "frame" if "frame" in mesh.shape else None
    D, g = mesh.size("gauss"), mesh.index("gauss")
    B, f = (mesh.size(frame), mesh.index(frame)) if frame else (1, 0)
    C = B * D  # one camera a rank
    s = render_scene(C, seed, blind=spec.get("blind", False))
    N = SCENE["N"]
    n, c = N // D, C // (B * D)
    rows = slice(g * n, (g + 1) * n)
    cams = slice((f * D + g) * c, (f * D + g + 1) * c)
    col = slice(f * C // B, (f + 1) * C // B)  # the cameras of this rank's column
    W, H = SCENE["width"], SCENE["height"]
    grads_on = spec.get("grads", True)
    kw = render_kw(spec)
    w = {k: torch.as_tensor(v, device=dev) for k, v in s.items() if k.startswith("w_")}

    def t(x):
        return torch.as_tensor(x, device=dev)

    full = {"means": t(s["means"]), "quats": t(s["quats"]), "scales": t(s["scales"]),
            "opacities": t(s["opacities"]),
            "colors": t(s["colors_cam"] if spec.get("per_camera_colors") else s["sh"])}
    if spec["kind"] == "replicated":
        local = {k: v.clone() for k, v in full.items()}
    else:
        local = {k: v[rows].clone() for k, v in full.items() if k != "colors"}
        local["colors"] = (full["colors"][col, rows] if spec.get("per_camera_colors")
                           else full["colors"][rows]).clone()
    taps = {k: torch.zeros((C // B, n, 2), device=dev)
            for k, on in (("means2d_offset", spec.get("offset_tap")),
                          ("means2d_abs_tap", spec.get("abs_tap"))) if on}
    viewmats, Ks = t(s["viewmats"]), t(s["Ks"])
    leaves = dict(local, **taps)
    if spec["kind"] == "eval3d":
        leaves["viewmats"] = viewmats[cams].clone()
    if grads_on:
        for v in leaves.values():
            v.requires_grad_(True)
    bg = t(s["backgrounds"])[cams] if spec.get("backgrounds") else None
    vm = leaves.get("viewmats", viewmats[cams])
    args = (leaves["means"], leaves["quats"], leaves["scales"], leaves["opacities"],
            leaves["colors"], vm, Ks[cams], W, H, mesh)
    tap_kw = {k: leaves[k] for k in taps}
    with torch.set_grad_enabled(grads_on):
        if spec["kind"] == "3dgs":
            outs = SR.rasterization_sharded(*args, backgrounds=bg, batch_axis=frame,
                                            **tap_kw, **kw)
        elif spec["kind"] == "2dgs":
            outs = SR.rasterization_2dgs_sharded(*args, backgrounds=bg, **tap_kw, **kw)
        elif spec["kind"] == "eval3d":
            outs = SR.rasterization_eval3d_sharded(*args, backgrounds=bg, **kw)
        else:
            outs = SR.rasterization_replicated(*args, backgrounds=bg, **kw)
    meta = outs[-1]
    outs = outs[:-1]
    if spec["kind"] == "2dgs":
        outs = (outs[0], outs[1], outs[2], outs[3])  # colors, alphas, normals, distortion
    res = {"img": outs[0], "alpha": outs[1], "n_dropped": meta["n_dropped"]}
    if spec["kind"] == "2dgs":
        res.update(normals=outs[2], distort=outs[3])
    if spec["kind"] != "replicated":
        res.update(radii=meta["radii"], means2d=meta["means2d"])
    if grads_on:
        res.update({f"grad_{k}": v for k, v in zip(leaves, _grads(outs, w, cams, leaves))})

    # the single-rank render of the same cameras, from every gaussian
    sfull = {k: v.clone() for k, v in full.items()}
    staps = {k: torch.zeros((c, N, 2), device=dev) for k in taps}
    sleaves = dict(sfull, **staps)
    if spec["kind"] == "eval3d":
        sleaves["viewmats"] = viewmats[cams].clone()
    if grads_on:
        for v in sleaves.values():
            v.requires_grad_(True)
    colors = sleaves["colors"][cams] if spec.get("per_camera_colors") else sleaves["colors"]
    svm = sleaves.get("viewmats", viewmats[cams])
    sargs = (sleaves["means"], sleaves["quats"], sleaves["scales"], sleaves["opacities"],
             colors, svm, Ks[cams], W, H)
    skw = dict(kw, tile_capacity=SCENE["tile_capacity"], device=dev,
               **{k: sleaves[k] for k in staps})
    with torch.set_grad_enabled(grads_on):
        if spec["kind"] == "2dgs":
            o = rasterization_2dgs(*sargs, backgrounds=bg, **skw)
            souts = (o[0], o[1], rotate(svm[:, :3, :3], o[2]), o[4])
        elif spec["kind"] == "eval3d":
            souts = rasterization(*sargs, backgrounds=bg, with_eval3d=True, **skw)[:2]
        else:
            souts = rasterization(*sargs, backgrounds=bg, **skw)[:2]
    res.update({f"single_{k}": v for k, v in zip(("img", "alpha", "normals", "distort"),
                                                    souts)})
    if grads_on:
        for k, v in zip(sleaves, _grads(souts, w, cams, sleaves)):
            if k == "viewmats":
                res["single_grad_viewmats"] = v
                continue
            if k in taps:
                # per (camera, gaussian): this rank's column of cameras
                v = comm.all_gather(v, mesh.group("gauss"))[:, rows]
            elif k == "colors" and spec.get("per_camera_colors"):
                v = comm.all_reduce_sum(v)[col, rows]
            else:
                v = comm.all_reduce_sum(v)
                v = v if spec["kind"] == "replicated" else v[rows]
            res[f"single_grad_{k}"] = v
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in res.items()}


def render_cases(names, mesh_shape=None, device: DeviceLike = None, seed: int = 0):
    """``render_case`` for each of ``names`` (of ``RENDER_CASES`` and
    ``MESH2D_CASES``) on this rank; ``mesh_shape`` (frame, gauss) makes the
    2-D mesh."""
    if mesh_shape is None:
        mesh = make_mesh(device=device)
    else:
        mesh = make_mesh(("frame", "gauss"), mesh_shape, device=device)
    cases = dict(RENDER_CASES, **MESH2D_CASES)
    return {name: render_case(cases[name], mesh, seed) for name in names}


# ---------------------------------------------------------------------------
# the sharded Runner
# ---------------------------------------------------------------------------


def _sharded_runner(cfg_dict: Dict, device: DeviceLike, **changes):
    from tdgs_torch.convert import config_from_dict
    from tdgs_torch.training.trainer import Runner

    d = dict(cfg_dict, sharded=True, **changes)
    return Runner(config_from_dict(d), device=device)


def trainer_cases(cfg_dict: Dict, state0: Dict, variants: Dict[str, Dict],
                  device: DeviceLike = None):
    """The sharded ``Runner`` on this rank, from ``cfg_dict``
    (``convert.config_to_dict`` form) and a global numpy state ``state0``
    (``Runner.state_numpy`` form):

    - ``step``: one training step from ``state0`` cut to this rank's block
      (``convert.shard_rows``): the history and the whole state after it;
    - ``refine``: a DefaultStrategy refine (dupli, split, prune) of the
      runner's state through ``Runner.strategy_post_backward``, and the same
      refine on the whole arrays with a generator in the same state;
    - ``mcmc``: MCMC relocations and growth over a few steps, and the same
      steps' MCMC refine on the whole arrays;
    - ``eval``: the C = 1 eval of the gathered splats;
    - ``ckpt``: the state saved with ``ckpt_format="orbax"`` under the
      result directory and loaded by a fresh sharded runner;
    - ``variants``: ``runner_variants(variants)``."""
    from tdgs_torch import convert
    from tdgs_torch.strategy import DefaultStrategy, MCMCStrategy

    out: Dict = {}
    runner = _sharded_runner(cfg_dict, device)
    mesh = runner.mesh
    cap = runner.capacity
    blocks = convert.runner_state_from_numpy(
        convert.shard_rows(state0, mesh.rank, mesh.world, cap), device=runner.device)
    runner.load_state_numpy(blocks, blocks=True)
    out["step"] = {"history": runner.train()["history"], "state": runner.state_numpy(1)}
    out["eval"] = runner.eval(1)

    # a Default refine and opacity reset on the state after the step: half
    # of the gaussians with a large screen gradient, every third one large
    # (splits), every fifth one too large (prunes), every seventh one small
    # (duplicates), every fourth one dead (free rows)
    strat = runner.strategy
    assert isinstance(strat, DefaultStrategy)
    strat.refine_start_iter, strat.refine_every, strat.refine_stop_iter = 0, 1, 10_000
    strat.reset_every = 1
    n = cap // mesh.world
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    rng = np.random.default_rng(5)
    grad2d = rng.uniform(0.0, 2e-3, size=cap).astype(np.float32)
    runner.strategy_state["grad2d"] = torch.as_tensor(grad2d[rows], device=runner.device)
    runner.strategy_state["count"] = torch.ones(n, device=runner.device)
    with torch.no_grad():
        runner.splats["opacities"][::4] = -7.0
        runner.splats["scales"][1::3] = float(np.log(0.05 * runner.scene_scale))
        runner.splats["scales"][2::5] = float(np.log(0.5 * runner.scene_scale))
        runner.splats["scales"][3::7] = float(np.log(0.005 * runner.scene_scale))
    whole = runner._gather(runner._trees()).values()
    gen = torch.Generator(device=runner.device).set_state(runner.generator.get_state())
    want = strat.step_post_backward(*whole, 2, {}, gen, lr=0.0)
    runner.strategy_post_backward(2, {}, 0.0)
    got = list(runner._gather(runner._trees()).values())
    out["refine"] = {"got": convert.tree_to_numpy(got), "want": convert.tree_to_numpy(want),
                     "last_refine": dict(strat.last_refine)}

    # the sharded checkpoint, written by every rank and read by a new world
    runner.cfg.ckpt_format = "orbax"
    path = runner.save_checkpoint(7)
    saved = runner.state_numpy(7)
    runner.close()
    fresh = _sharded_runner(cfg_dict, device, ckpt_format="orbax")
    step = fresh.load_checkpoint(path)
    out["ckpt"] = {"path": path, "step": step, "saved": saved, "loaded": fresh.state_numpy(7)}
    fresh.close()

    # MCMC: relocation and growth over a few steps, and one refine against
    # the whole arrays
    mc = dict(cfg_dict["strategy"], type="MCMCStrategy")
    mc = {k: v for k, v in mc.items() if k in ("type", "verbose")}
    mc.update(cap_max=cap, refine_start_iter=1, refine_every=2, refine_stop_iter=1000)
    runner = _sharded_runner(cfg_dict, device, strategy=mc, max_steps=5, init_opa=0.5)
    assert isinstance(runner.strategy, MCMCStrategy)
    alive0 = runner._alive_count()
    hist = runner.train()["history"]
    out["mcmc"] = {"history": hist, "refines": runner.refines, "alive0": alive0,
                   "n_alive": int(runner.strategy_state["n_alive"])}
    whole = runner._gather(runner._trees()).values()
    gen = torch.Generator(device=runner.device).set_state(runner.generator.get_state())
    want = runner.strategy.step_post_backward(*whole, 6, {}, gen, lr=1e-3)
    runner.strategy_post_backward(6, {}, 1e-3)
    got = list(runner._gather(runner._trees()).values())
    out["mcmc"]["got"] = convert.tree_to_numpy(got)
    out["mcmc"]["want"] = convert.tree_to_numpy(want)
    runner.close()
    out["variants"] = runner_variants(variants, device)
    return out


def runner_variants(cfg_dicts: Dict[str, Dict], device: DeviceLike = None) -> Dict[str, Dict]:
    """Each named config (``convert.config_to_dict`` form) trained by a
    sharded ``Runner`` on this rank: the loss history and the whole state
    after it, for the caller to hold against the single-rank Runner."""
    out = {}
    for name, cfg_dict in cfg_dicts.items():
        runner = _sharded_runner(cfg_dict, device)
        hist = runner.train()["history"]
        out[name] = {"history": hist, "state": runner.state_numpy(runner.cfg.max_steps),
                     "refines": runner.refines}
        runner.close()
    return out


def viewer_case(cfg_dict: Dict, device: DeviceLike = None) -> Dict:
    """The sharded ``Runner`` from ``cfg_dict`` with the live viewer on
    (rank 0 serves on a free port): a client thread on rank 0 fetches
    frames in a loop while every rank trains; then rank 0 renders each
    mode of the last gathered copy. Also ``rendering.rasterization(...,
    distributed=True)`` of a seeded scene, each rank with its block of
    gaussians and its camera, beside ``parallel.rasterization_sharded`` on
    the same inputs. Returns (per rank) the frames served during training
    and their HTTP statuses, the training's history and wall times, the
    modes' frames and both renders."""
    import threading
    import time
    import urllib.error
    import urllib.request

    from tdgs_torch.parallel.sharded_render import rasterization_sharded
    from tdgs_torch.rendering import rasterization
    from tdgs_torch.viewer.server import RenderTabState

    out: Dict = {}
    runner = _sharded_runner(cfg_dict, device, disable_viewer=False, viewer_port=0)
    served, statuses = [], []
    stop = threading.Event()

    def client(port):
        while not stop.is_set():
            url = f"http://127.0.0.1:{port}/render?w=48&h=32&dist=3"
            try:
                with urllib.request.urlopen(url, timeout=60) as r:
                    statuses.append(r.status)
                    if r.read(2) == b"\xff\xd8":
                        served.append(time.monotonic())
            except urllib.error.HTTPError as e:
                statuses.append(e.code)

    th = None
    if runner.viewer is not None:
        th = threading.Thread(target=client, args=(runner.viewer.port,), daemon=True)
        th.start()
    t0 = time.monotonic()
    out["history"] = runner.train()["history"]
    t1 = time.monotonic()
    if th is not None:
        # one more frame after training, then stop the client
        n = len(served)
        while len(served) == n and th.is_alive() and time.monotonic() < t1 + 60:
            time.sleep(0.01)
        stop.set()
        th.join(timeout=60)
        vm = np.asarray(runner.trainset[0]["viewmat"])
        K = np.asarray(runner.trainset[0]["K"])
        out["modes"] = {m: runner._viewer_render_fn(vm, K, 48, 32, RenderTabState(render_mode=m))
                        for m in ("rgb", "depth", "alpha")}
    out.update(served=[t - t0 for t in served], statuses=statuses, train_s=t1 - t0,
               has_viewer=runner.viewer is not None)
    runner.close()

    sc = render_scene(2, seed=4)
    mesh = runner.mesh
    n = sc["means"].shape[0] // mesh.world
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    dev = mesh.device
    ins = [torch.as_tensor(sc[k][rows], device=dev)
           for k in ("means", "quats", "scales", "opacities", "sh")]
    cams = [torch.as_tensor(sc[k][mesh.rank:mesh.rank + 1], device=dev)
            for k in ("viewmats", "Ks")]
    kw = dict(sh_degree=1, tile_capacity=256, rasterizer="packed_inference")
    W, H = SCENE["width"], SCENE["height"]
    got = rasterization(*ins, *cams, W, H, distributed=True, device=dev, **kw)
    want = rasterization_sharded(*ins, *cams, W, H, mesh, **kw)
    out["distributed"] = {"got": [got[0].cpu().numpy(), got[1].cpu().numpy()],
                          "want": [want[0].cpu().numpy(), want[1].cpu().numpy()]}
    return out
