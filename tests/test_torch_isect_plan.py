"""Port parity of the packed tiling's plan and its golden check:
``derive_isect_plan`` and the two-population ``split_k`` expansion of
``isect_tiles_packed`` against ``tdgs.ops.tiling``, ``compose_reference_f64``
against ``tdgs.utils.golden``, and the port's packed render against that
float64 recomposition of its own stream.

The JAX sort is unstable, so streams are compared per tile: offsets,
counts, lengths, and each tile's multiset of keys and flatten ids."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops import tiling as jtiling
from tdgs.utils.golden import compose_reference_f64 as j_compose
from tdgs_torch.ops import tiling as ttiling
from tdgs_torch.utils.golden import compose_reference_f64 as t_compose
from tests.test_torch_tiling import _assert_same_stream, _both, _inputs


def _plan_scene(seed, n, n_big, big_scale, W=320, H=240):
    """Small splats in front of the camera and ``n_big`` large ones."""
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(n, 3)) * [1.5, 1.0, 0.5] + [0, 0, 6]).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.005, 0.02, size=(n, 3)).astype(np.float32)
    scales[:n_big] = big_scale
    opac = rng.uniform(0.3, 1.0, size=n).astype(np.float32)
    sh = (rng.normal(size=(n, 4, 3)) * 0.3).astype(np.float32)
    f = 300.0
    Ks = np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]], np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None]
    return dict(means=means, quats=quats, scales=scales, opacities=opac, sh=sh,
                viewmats=viewmats, Ks=Ks, W=W, H=H)


_PLAN_CASES = {
    # most splats cover 1-2 tiles: a split at 2 pays
    "split": (dict(seed=1, n=4000, n_big=30, big_scale=0.12), 64),
    # a few splats cover 169 tiles, beyond the cap of 32
    "kmax_over_cap": (dict(seed=2, n=3000, n_big=10, big_scale=0.6), 32),
    # too few gaussians for a split to pay
    "dense": (dict(seed=3, n=300, n_big=3, big_scale=0.12), 32),
}


@pytest.mark.parametrize("case", list(_PLAN_CASES))
def test_derive_isect_plan_matches_jax(case):
    kw, cap = _PLAN_CASES[case]
    sc = _plan_scene(**kw)
    args = [sc[k] for k in ("means", "quats", "scales", "opacities", "viewmats", "Ks")]
    want = jtiling.derive_isect_plan(*map(jnp.asarray, args), sc["W"], sc["H"],
                                     max_tiles_per_gauss=cap)
    got = ttiling.derive_isect_plan(*args, sc["W"], sc["H"], max_tiles_per_gauss=cap,
                                    device="cpu")
    assert got == want
    if case == "split":
        assert got["isect_split_k"] is not None
    elif case == "kmax_over_cap":
        assert got["footprint_kmax"] > cap
    else:
        assert got["isect_split_k"] is None


def test_rally_plan_falls_back_to_exact_coverage():
    from tdgs_torch.rally_e2e import rally_plan

    for case, fallback in (("split", False), ("kmax_over_cap", True)):
        sc = _plan_scene(**_PLAN_CASES[case][0])
        splats = {"means": torch.from_numpy(sc["means"]), "quats": torch.from_numpy(sc["quats"]),
                  "scales": torch.log(torch.from_numpy(sc["scales"])),
                  "opacities": torch.logit(torch.from_numpy(sc["opacities"]))}
        plan, derived, fell = rally_plan(splats, torch.from_numpy(sc["viewmats"][0]),
                                         torch.from_numpy(sc["Ks"][0]), sc["W"], sc["H"], "cpu")
        assert fell is fallback
        if fallback:
            assert plan == {"isect_capacity": -(-int(derived["full_isect_demand"] * 1.3)
                                                // 4096) * 4096, "isect_exact": True}
        else:
            assert "footprint_kmax" not in plan and plan["max_tiles_per_gauss"] == 16


@pytest.mark.parametrize(
    "case",
    [
        dict(max_tiles_per_gauss=16, split_k=4),
        # every gaussian is big: the default G/4 (128) keeps 128 tails
        dict(max_tiles_per_gauss=16, split_k=2, big=True, overflow=True),
        dict(max_tiles_per_gauss=16, split_k=4, capacity=600, big=True, big_capacity=300),
        dict(max_tiles_per_gauss=8, split_k=3, exact_depth=True, big=True, big_capacity=384),
        dict(max_tiles_per_gauss=16, split_k=4, I=2),
    ],
    ids=["split", "big_capacity_overflow", "split_capacity", "split_exact_depth",
         "split_2images"],
)
def test_isect_split_k_matches_jax_and_capped(case):
    case = dict(case)
    I, big, overflow = case.pop("I", 1), case.pop("big", False), case.pop("overflow", False)
    inputs = _inputs(305, N=300, I=I, big=big)
    got, want = _both(*inputs, **case)
    # the stream's length too: G·split_k + big_capacity·(K − split_k), cut
    # at the capacity
    _assert_same_stream(got, want, ordered=case.get("exact_depth", False))
    case.pop("split_k")
    case.pop("big_capacity", None)
    capped = ttiling.isect_tiles_packed(*(torch.from_numpy(a) for a in inputs[:3]), 16,
                                        *inputs[3:], **case)
    if overflow:
        # the big gaussians past the first 128 lose their tails
        assert got.n_dropped > capped.n_dropped
        assert got.n_isects + got.n_dropped == capped.n_isects + capped.n_dropped
        return
    assert (got.n_isects, got.n_dropped) == (capped.n_isects, capped.n_dropped)
    offs = got.offsets.numpy()
    np.testing.assert_array_equal(offs, capped.offsets.numpy())
    for t in range(len(offs) - 1):
        s, e = offs[t], offs[t + 1]
        np.testing.assert_array_equal(np.sort(got.flatten_ids[s:e].numpy()),
                                      np.sort(capped.flatten_ids[s:e].numpy()))


def _stream(seed=1):
    """The packed stream of a plan scene and its colours, from the port."""
    from tdgs_torch.ops.sh import spherical_harmonics
    from tdgs_torch.rendering import rasterization

    sc = _plan_scene(**_PLAN_CASES["split"][0]) if seed == 1 else _plan_scene(
        seed=seed, n=1500, n_big=20, big_scale=0.2)
    plan = ttiling.derive_isect_plan(*(sc[k] for k in ("means", "quats", "scales", "opacities",
                                                        "viewmats", "Ks")),
                                     sc["W"], sc["H"], device="cpu")
    for k in ("footprint_kmax", "full_isect_demand"):
        plan.pop(k)
    bg = np.array([[0.78, 0.78, 0.78]], np.float32)
    img, _, meta = rasterization(sc["means"], sc["quats"], sc["scales"], sc["opacities"],
                                 sc["sh"], sc["viewmats"], sc["Ks"], sc["W"], sc["H"],
                                 sh_degree=1, backgrounds=bg, isect_exact_depth=True,
                                 tile_capacity=2048, device="cpu", **plan)
    cols = torch.clamp(spherical_harmonics(1, torch.from_numpy(sc["means"]),
                                           torch.from_numpy(sc["sh"])) + 0.5, min=0.0)
    args = (meta["isect_offsets"].numpy(), meta["flatten_ids"].numpy(),
            meta["means2d"].numpy().reshape(-1, 2), meta["conics"].numpy().reshape(-1, 3),
            cols.numpy(), sc["opacities"], sc["W"], sc["H"], meta["tile_size"],
            meta["tile_width"], meta["tile_height"])
    return img[0].numpy(), args, dict(background=bg[0].astype(np.float64),
                                      n_isects=meta["n_isects"]), plan


def test_compose_reference_f64_bitwise_equal_to_jax():
    _, args, kw, _ = _stream(seed=4)
    got, want = t_compose(*args, **kw), j_compose(*args, **kw)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # the [I, th, tw] per-tile starts of the dense tiling, closed by n_isects
    dense = np.asarray(args[0])[:-1]
    np.testing.assert_array_equal(t_compose(dense, *args[1:], **kw), want)


def test_packed_render_against_f64_golden():
    from tdgs_torch.rally_e2e import psnr_np

    img, args, kw, plan = _stream(seed=1)
    assert plan["isect_split_k"] is not None  # the split stream, rendered
    oracle = t_compose(*args, **kw)
    psnr = psnr_np(np.clip(img, 0, 1), np.clip(oracle, 0, 1))
    assert psnr >= 40.0, psnr
