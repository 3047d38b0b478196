"""Port parity of ``tdgs_torch.parallel.sharded_render`` against
``tdgs.parallel.sharded_render`` at D = 2 (and the 2-D mesh at 2 × 2), and
against the port's own single-rank ``rasterization`` of each rank's
cameras.

The port runs as SPMD ranks: one gloo world of 2 CPU ranks (and one of 4
for the 2-D mesh) renders every case of ``parallel.checks`` once, in a
module-scoped fixture; each test holds one case. The JAX side runs the
same global inputs through ``jax.shard_map`` on 2 (4) of the conftest's
8 CPU devices, jitted; its Pallas kernels in interpret mode. The rank
results are put back together along the camera axis (outputs) and the
gaussian axis (gradients, pre-exchange meta).

Tolerances, those of the port's single-device tests of each rasterizer:
"packed"/"packed_inference" (test_torch_rendering, _rasterize_packed_grad)
2e-3 absolute on outputs, the ED depth channel 2e-3 relative where
alpha > 0.1, gradients max|Δ| ≤ 1e-3·max|ref|; "jax" 1e-5 and 1e-4,
"pallas" 1e-4 and 1e-3 (test_torch_rasterize_dense); 2DGS 2e-3 and 1e-3
(test_torch_2dgs_training, JAX handed Mᵀ); eval3d 5e-3 and 3e-2
(test_torch_rasterize_eval3d). Radii equal but for ±1 in at most 1% of
the entries (one float32 rounding can move a ceil), pre-exchange means2d
1e-4 absolute, ``n_dropped`` equal.
"""

import concurrent.futures

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import tdgs.ops.projection_2dgs as jproj2
from tdgs.parallel import (
    make_mesh,
    rasterization_2dgs_sharded,
    rasterization_eval3d_sharded,
    rasterization_replicated,
    rasterization_sharded,
)
from tdgs_torch.parallel import checks, launch

# (atol on outputs, rtol on gradients) by rasterizer family
TOLS = {"packed": (2e-3, 1e-3), "packed_inference": (2e-3, 1e-3), "jax": (1e-5, 1e-4),
        "pallas": (1e-4, 1e-3), "2dgs": (2e-3, 1e-3), "eval3d": (5e-3, 3e-2)}
WORLD_TIMEOUT_S = 300


def _port_results():
    """Every case rendered by the port once: {case: [rank results]}."""
    res = launch.run(checks.render_cases, 2, sorted(checks.RENDER_CASES), None, "cpu",
                     device="cpu", timeout_s=WORLD_TIMEOUT_S)
    out = {name: [r[name] for r in res] for name in checks.RENDER_CASES}
    res4 = launch.run(checks.render_cases, 4, sorted(checks.MESH2D_CASES), (2, 2), "cpu",
                      device="cpu", timeout_s=WORLD_TIMEOUT_S)
    out.update({name: [r[name] for r in res4] for name in checks.MESH2D_CASES})
    return out


def _tols(spec):
    if spec["kind"] in ("2dgs", "eval3d"):
        return TOLS[spec["kind"]]
    return TOLS[spec["rasterizer"]]


def _rel(got, want, rtol, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max|Δ| {err} > {rtol} · {scale}"


def _outputs_close(got, want, spec, atol, name):
    """Colours (the ED channel relatively where alpha > 0.1), alphas and,
    for 2DGS, normals and distortion."""
    got_img, want_img = got["img"], want["img"]
    assert got_img.shape == want_img.shape, (name, got_img.shape, want_img.shape)
    np.testing.assert_allclose(got["alpha"], want["alpha"], atol=atol, err_msg=f"{name}/alpha")
    if spec["render_mode"].endswith("ED"):
        seen = want["alpha"][..., 0] > 0.1
        np.testing.assert_allclose(got_img[..., -1][seen], want_img[..., -1][seen],
                                   rtol=2e-3, err_msg=f"{name}/expected depth")
        got_img, want_img = got_img[..., :-1], want_img[..., :-1]
    np.testing.assert_allclose(got_img, want_img, atol=atol, err_msg=f"{name}/colors")
    for k in ("normals", "distort"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=f"{name}/{k}")


def _assemble(ranks, spec, mesh_shape):
    """The ranks' results as the JAX package's global arrays: outputs by
    camera, gradients and pre-exchange meta by gaussian (the 2-D mesh:
    gradients from the first frame row, taps and meta by (frame, gauss))."""
    B, D = mesh_shape
    out = {k: np.concatenate([r[k] for r in ranks]) for k in
           ("img", "alpha", "normals", "distort", "n_dropped") if k in ranks[0]}
    grid = [[ranks[f * D + g] for g in range(D)] for f in range(B)]
    for k in ranks[0]:
        if k.startswith("single") or k in out:
            continue
        per_cam = k in ("radii", "means2d", "grad_means2d_offset", "grad_means2d_abs_tap") or (
            k == "grad_colors" and spec.get("per_camera_colors"))
        if k == "grad_viewmats" or spec["kind"] == "replicated":
            out[k] = np.concatenate([r[k] for r in ranks])
        elif per_cam:
            out[k] = np.concatenate(
                [np.concatenate([r[k] for r in row], axis=1) for row in grid], axis=0)
        else:
            out[k] = np.concatenate([r[k] for r in grid[0]])
    return out


def _jax_case(name, spec, mesh_shape):
    """The JAX package's sharded render of the case's global inputs:
    outputs, meta and the gradients of the same weighted sum."""
    B, D = mesh_shape
    C = B * D
    s = checks.render_scene(C, blind=spec.get("blind", False))
    kw = checks.render_kw(spec)
    devices = np.array(jax.devices()[:B * D])
    if B > 1:
        mesh = Mesh(devices.reshape(B, D), ("frame", "gauss"))
        kw["batch_axis"] = "frame"
    else:
        mesh = make_mesh(devices=list(devices))
    colors = s["colors_cam"] if spec.get("per_camera_colors") else s["sh"]
    leaves = {k: jnp.asarray(s[k]) for k in ("means", "quats", "scales", "opacities")}
    leaves["colors"] = jnp.asarray(colors)
    N = s["means"].shape[0]
    for tap, on in (("means2d_offset", spec.get("offset_tap")),
                    ("means2d_abs_tap", spec.get("abs_tap"))):
        if on:
            leaves[tap] = jnp.zeros((C, N, 2), jnp.float32)
    if spec["kind"] == "eval3d":
        leaves["viewmats"] = jnp.asarray(s["viewmats"])
    bg = jnp.asarray(s["backgrounds"]) if spec.get("backgrounds") else None
    W, H = checks.SCENE["width"], checks.SCENE["height"]
    fn = {"3dgs": rasterization_sharded, "2dgs": rasterization_2dgs_sharded,
          "eval3d": rasterization_eval3d_sharded,
          "replicated": rasterization_replicated}[spec["kind"]]
    if spec["kind"] != "3dgs":
        kw.pop("rasterize_mode", None)
    if spec["kind"] == "eval3d":
        kw.pop("rasterizer", None)

    def render(lv):
        return fn(lv["means"], lv["quats"], lv["scales"], lv["opacities"], lv["colors"],
                  lv.get("viewmats", jnp.asarray(s["viewmats"])), jnp.asarray(s["Ks"]), W, H,
                  mesh, backgrounds=bg,
                  **{k: lv[k] for k in ("means2d_offset", "means2d_abs_tap") if k in lv},
                  **kw)

    def outputs(lv):
        outs = render(lv)
        meta = outs[-1]
        return outs[:2] + ((outs[2], outs[3]) if spec["kind"] == "2dgs" else ()), meta

    def loss(lv):
        outs, meta = outputs(lv)
        total = jnp.sum(outs[0] * s["w_img"][..., :outs[0].shape[-1]])
        total = total + jnp.sum(outs[1] * s["w_alpha"])
        if len(outs) > 2:
            total = total + jnp.sum(outs[2] * s["w_normals"]) + jnp.sum(outs[3] * s["w_distort"])
        return total, (outs, meta)

    grads = None
    if spec.get("grads", True):
        # one compile for the outputs and the gradients
        (_, (outs, meta)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(leaves)
    else:
        outs, meta = jax.jit(outputs)(leaves)
    want = {"img": np.asarray(outs[0]), "alpha": np.asarray(outs[1]),
            "n_dropped": np.asarray(meta["n_dropped"])}
    if spec["kind"] == "2dgs":
        want.update(normals=np.asarray(outs[2]), distort=np.asarray(outs[3]))
    if spec["kind"] != "replicated":
        want.update(radii=np.asarray(meta["radii"]), means2d=np.asarray(meta["means2d"]))
    if grads is not None:
        want.update({f"grad_{k}": np.asarray(v) for k, v in grads.items()})
    return want


CASES = sorted(dict(checks.RENDER_CASES, **checks.MESH2D_CASES))
SPECS = dict(checks.RENDER_CASES, **checks.MESH2D_CASES)


def _mesh_shape(case):
    return (2, 2) if case in checks.MESH2D_CASES else (1, 2)


@pytest.fixture(scope="module")
def results():
    """The port's ranks of every case and the JAX package's sharded render
    of every case: the port's worlds run while the JAX side compiles. The
    JAX 2DGS path is handed Mᵀ (the port reads M's columns) and the unit
    surfel normal (``jax_project_fixed``; ROADMAP, faults on the reference
    side)."""
    from tests.test_torch_2dgs_training import jax_project_fixed

    transposed = jax_project_fixed(jproj2.fully_fused_projection_2dgs)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_results)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jproj2, "fully_fused_projection_2dgs", transposed)
            want = {case: _jax_case(case, SPECS[case], _mesh_shape(case)) for case in CASES}
        return port.result(), want


@pytest.mark.parametrize("case", CASES)
def test_sharded_render_matches_jax_and_single_rank(case, results):
    spec = SPECS[case]
    atol, rtol = _tols(spec)
    ranks = results[0][case]
    # each rank against the port's single-rank render of its cameras
    for r, res in enumerate(ranks):
        single = {k[len("single_"):]: v for k, v in res.items() if k.startswith("single_")}
        _outputs_close(res, single, spec, atol, f"{case}/rank{r}/single")
        for k, v in single.items():
            if k.startswith("grad_"):
                _rel(res[k], v, rtol, f"{case}/rank{r}/single/{k}")
        assert np.isfinite(res["img"]).all()
    # the ranks together against the JAX package's sharded render
    got = _assemble(ranks, spec, _mesh_shape(case))
    want = results[1][case]
    _outputs_close(got, want, spec, atol, f"{case}/jax")
    np.testing.assert_array_equal(got["n_dropped"], want["n_dropped"])
    if "radii" in want:
        diff = np.abs(got["radii"].astype(np.int64) - want["radii"])
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, case
        live = (want["radii"] > 0).all(-1)
        np.testing.assert_allclose(got["means2d"][live], want["means2d"][live], atol=1e-4)
    grads = sorted(k for k in want if k.startswith("grad_"))
    assert grads == sorted(k for k in got if k.startswith("grad_")), case
    for k in grads:
        _rel(got[k], want[k], rtol, f"{case}/jax/{k}")
    if case == "blind_rank":
        # the rank whose camera sees nothing renders background only
        assert not ranks[1]["alpha"].any() and ranks[0]["alpha"].any()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the refusal on a machine without a card")
def test_entry_points_default_to_the_card():
    """``launch.run``, the ranks' check functions and ``checkpoint.load``
    run on the card unless given ``device="cpu"``: without one they raise
    before anything is spawned or read."""
    from tdgs_torch.parallel import checkpoint

    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.run(checks.comm_case, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load("no_such_checkpoint")


def test_row_leaves_are_chosen_by_place_not_shape():
    """``parallel.rows``: every array of the splats and the Adam moments and
    the strategies' accumulators are rows; a strategy table, a step or a
    head whose leading axis happens to equal the block is left whole."""
    from tdgs_torch.parallel import rows

    n = 4
    state = {
        "step": 3,
        "splats": {"means": torch.zeros(n, 3), "opacities": torch.zeros(n)},
        "opt_state": {"mu": {"means": torch.zeros(n, 3)}, "nu": {"means": torch.zeros(n, 3)}},
        "strategy_state": {"grad2d": torch.zeros(n), "binoms": torch.zeros(n, n),
                           "n_alive": torch.tensor(2), "scene_scale": 1.0},
        "segmentation_head": {"w1": torch.zeros(n, n)},
    }
    seen = []
    out = rows.map_rows(lambda x: seen.append(tuple(x.shape)) or x[:1], state)
    assert sorted(seen) == sorted([(n, 3), (n,), (n, 3), (n, 3), (n,)])
    assert out["splats"]["means"].shape == (1, 3)
    assert out["opt_state"]["nu"]["means"].shape == (1, 3)
    assert out["strategy_state"]["grad2d"].shape == (1,)
    assert out["strategy_state"]["binoms"].shape == (n, n)
    assert out["segmentation_head"]["w1"].shape == (n, n) and out["step"] == 3
    assert rows.is_rows(("opt_state", "exp_avg", "quats"), 2)
    assert not rows.is_rows(("strategy_state", "n_alive"), 0)
    assert not rows.is_rows(("strategy_state", "binoms"), 2)
