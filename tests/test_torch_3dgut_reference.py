"""The port's 3DGUT path against the benchmark's plain reference
(``portbench/reference/render_3dgut.py``, plain PyTorch written from the
paper) on seeded random gaussians of the benchmark's state generator at a
small size, on the CPU (the kernels' plain versions):

- the unscented projection: the means2d, and the radii as the tiles they
  cover (the port's exact stream against the reference's binning, entry
  for entry);
- the world-space forward image and alpha, and the gradients of means,
  quats, scales, opacities and the SH colours;
- one 3DGUT MCMC ``Runner`` step through the benchmark's driver at a size
  a CPU holds: its losses, the gradient Adam received and the change;
- ``derive_isect_plan(with_ut=True)``'s demand against the UT stream's, and
  ``with_ut=False`` as before;
- the tiles' cut counted in ``n_dropped``;
- the reference in bfloat16, or with the response taken at the centre's
  depth in place of the closest approach, fails the forward comparison.

Tolerances: the same float32 arithmetic in another order of operations:
the forward 1e-5 absolute (read: 5.4e-7), the gradients 1e-4 of each
group's largest (read: 3.9e-6), the Runner step's loss and gradient gaps
1e-4 (read: 3.2e-6, 4.9e-7) and its change 5e-4 (read: 2.2e-5: three
steps of Adam, whose step is a ratio of small moments, and a relocation).
"""

import json
import math
import os
from types import SimpleNamespace

import pytest
import torch

import tdgs_torch
from portbench.reference import render as R
from portbench.reference import render_3dgut as R3
from portbench.scenes import rich
from portbench.scenes.state import trained_state
from tdgs_torch.ops import tiling
from tdgs_torch.ops.projection_ut import fully_fused_projection_with_ut

SPEC = {"surface_jitter": 0.2, "log_scale_sd": 0.35, "flatness": 0.3, "big_share": 0.05,
        "big_mult": 2.5, "dead_share": 0.05, "shn_sd": 0.05}
W, H = 48, 32
FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4
CASES = [(20, 1, 1), (120, 2, 3), (300, 3, 6), (2000, 4, 2)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(n, seed, view):
    st = trained_state(n, seed, "cpu", SPEC)
    vms, K = rich.cameras(8, W, H)
    return st, torch.as_tensor(vms[view]), torch.as_tensor(K)


def _act(p):
    return (p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]),
            torch.cat([p["sh0"], p["shN"]], 1))


def _port(p, vm, K, bg=None, tile_capacity=4096, isect_exact=True):
    means, quats, scales, op, sh = _act(p)
    img, alpha, meta = tdgs_torch.rasterization(
        means, quats, scales, op, sh, vm[None], K[None], W, H, sh_degree=3,
        with_ut=True, with_eval3d=True, isect_exact=isect_exact, tile_capacity=tile_capacity,
        backgrounds=bg, device="cpu")
    return img[0], alpha[0, ..., 0], meta


def _ref(p, vm, K, **kw):
    return R3.render(*_act(p), vm, K, W, H, **kw)


@pytest.mark.parametrize("n,seed,view", CASES)
def test_ut_projection_means_and_tiles(n, seed, view):
    st, vm, K = _scene(n, seed, view)
    means, quats, scales, op, _ = _act(st)
    radii, means2d, depths, _, _ = fully_fused_projection_with_ut(
        means, quats, scales, op, vm[None], K[None], W, H)
    pr = R3.project_ut(means, quats, scales, op, vm, K, W, H)
    assert bool(((radii[0] > 0).all(-1) == pr["valid"]).all())
    assert int(pr["valid"].sum()) > 0
    v = pr["valid"]
    # the moments' sums in another order: a few ulps of the pixel coordinate
    torch.testing.assert_close(means2d[0][v], pr["means2d"][v], rtol=0, atol=1e-4)
    torch.testing.assert_close(radii[0].float(), pr["radii"], rtol=0, atol=0)
    # the tiles covered, entry for entry in the stream's order
    tw, th = math.ceil(W / 16), math.ceil(H / 16)
    port = tiling.isect_tiles_packed(means2d, radii, depths, 16, tw, th, exact=True,
                                     capacity=1 << 20)
    tile, owner, _ = R.bin_tiles(pr["means2d"], pr["radii"], pr["depths"], pr["valid"], W, H)
    got = port.isect_keys[:port.n_isects].long() >> port.depth_bits
    assert torch.equal(got, tile) and torch.equal(port.flatten_ids[:port.n_isects].long(), owner)


@pytest.mark.parametrize("n,seed,view", CASES)
def test_forward_image_and_alpha(n, seed, view):
    st, vm, K = _scene(n, seed, view)
    img, alpha, meta = _port(st, vm, K, bg=torch.full((1, 3), 0.3))
    rgb, a, info = _ref(st, vm, K, background=torch.full((3,), 0.3))
    assert info["live_pairs"] > 0 and info["entries"] == meta["n_isects"]
    assert meta["n_dropped"] == 0
    assert float((img - rgb).abs().max()) < FWD_ATOL
    assert float((alpha - a).abs().max()) < FWD_ATOL


@pytest.mark.parametrize("n,seed,view", CASES)
def test_gradients(n, seed, view):
    st, vm, K = _scene(n, seed, view)
    w = torch.randn((H, W, 3), generator=torch.Generator().manual_seed(seed))
    leaves = {k: v.clone().requires_grad_(True) for k, v in st.items()}
    img, _, _ = _port(leaves, vm, K)
    (img * w).sum().backward()
    _, grads, info = R3.render_backward(st, vm, K, W, H, lambda rgb: (rgb * w).sum())
    assert int(info["visible"].sum()) > 0
    for k in ("means", "quats", "scales", "opacities", "sh0", "shN"):
        want, got = grads[k], leaves[k].grad
        scale = float(want.abs().max())
        assert scale > 0, k
        assert float((got - want).abs().max()) <= GRAD_RTOL * scale, k


@pytest.mark.parametrize("variant", ["bfloat16", "centre_depth"])
def test_wrong_reference_fails(variant):
    """Each wrong reference departs from the port well past the forward's
    tolerance, at every case."""
    kw = {"dtype": torch.bfloat16} if variant == "bfloat16" else {"response": variant}
    for n, seed, view in CASES:
        st, vm, K = _scene(n, seed, view)
        img, _, _ = _port(st, vm, K)
        rgb, _, _ = _ref(st, vm, K, **kw)
        assert float((img - rgb).abs().max()) > 10 * FWD_ATOL, (variant, n)


def _cell(width=64, height=48, n_gauss=3000):
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "portbench")

    def load(*parts):
        with open(os.path.join(here, *parts)) as fd:
            return json.load(fd)

    cfg = load("configs", "bicycle_3dgut.json")
    cfg["scene"].update(n_gt=3000, sfm_points=300, n_images=8, width=width, height=height)
    cfg["state"]["n_gauss"] = n_gauss
    cfg["trainer"]["cap_max"] = n_gauss
    traffic = dict(load("traffic", "train_3dgut_steady.json"), period=2, warm_steps=2)
    return SimpleNamespace(name="tiny.train", chips=1, config=cfg, traffic=traffic,
                           limits=load("workloads", "bicycle_3dgut.train.json")["limits"])


def test_runner_step_against_the_reference(tmp_path, monkeypatch):
    """The driver's checked steps on the system's CPU path: Runner.train
    with UT, eval3d and MCMC, three chained steps and a refine, against
    the reference's from the same state, images and generator."""
    from portbench import harness
    from portbench.drivers import train_3dgut

    monkeypatch.setattr(harness, "CACHE", str(tmp_path / "cache"))
    out = train_3dgut.run(_cell(), 2**31 + 12345, 0.0, False, "cpu", 0.0)
    v = out["values"]
    assert out["correct"] and out["failed"] == 0, out["compared"]
    assert v["loss_gap"] < 1e-4 and v["grad_gap"] < 1e-4, v
    assert v["change_gap"] < 5e-4, v
    assert out["ctx"]["plan"]["full_isect_demand"] > 0


@pytest.mark.parametrize("n,seed,view", CASES[1:])
def test_derive_isect_plan_with_ut(n, seed, view):
    st, vm, K = _scene(n, seed, view)
    means, quats, scales, op, sh = _act(st)
    plan = tiling.derive_isect_plan(means, quats, scales, op, vm[None], K[None], W, H,
                                    max_tiles_per_gauss=64, device="cpu", with_ut=True)
    _, _, meta = _port(st, vm, K)
    assert plan["full_isect_demand"] == meta["n_isects"] > 0
    ewa = tiling.derive_isect_plan(means, quats, scales, op, vm[None], K[None], W, H,
                                   max_tiles_per_gauss=64, device="cpu")
    assert tiling.derive_isect_plan(means, quats, scales, op, vm[None], K[None], W, H,
                                    max_tiles_per_gauss=64, device="cpu",
                                    with_ut=False) == ewa
    _, _, ewa_meta = tdgs_torch.rasterization(means, quats, scales, op, sh, vm[None], K[None],
                                              W, H, sh_degree=3, rasterizer="packed",
                                              isect_exact=True, device="cpu")
    assert ewa["full_isect_demand"] == ewa_meta["n_isects"]


@pytest.mark.parametrize("isect_exact", [True, False])
def test_tile_cut_counts_in_n_dropped(isect_exact):
    """A tile capacity below the fullest tile: every entry past a tile's
    kept 128 counts in ``n_dropped``, read from the stream's offsets."""
    st, vm, K = _scene(2000, 4, 2)
    _, _, meta = _port(st, vm, K, tile_capacity=128, isect_exact=isect_exact)
    off = meta["isect_offsets"]
    cut = int(torch.clamp(off[1:] - off[:-1] - 128, min=0).sum())
    assert cut > 0 and meta["n_dropped"] == cut
    _, _, full = _port(st, vm, K, isect_exact=isect_exact)
    assert full["n_dropped"] == 0
