"""Port parity: ``tdgs_torch.ops.tiling.isect_tiles_packed`` against
``tdgs.ops.tiling.isect_tiles_packed`` on the same projected gaussians.

The JAX sort is unstable, so the raw entry order is not compared: counts,
offsets and per-tile multisets of flatten ids are, and under
``exact_depth=True`` (distinct depths) the per-tile order too."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops import tiling as jtiling
from tdgs_torch.ops import tiling as ttiling
from tests.test_rasterize import make_raster_inputs


def _inputs(seed, N=120, width=64, height=48, I=1, big=False):
    rng = np.random.default_rng(seed)
    means2d, _, _, _, radii, depths, tw, th = make_raster_inputs(
        rng, I=I, N=N, width=width, height=height
    )
    if big:
        radii = np.maximum(radii, 20)  # footprints beyond the per-gauss cap
    radii[..., :5, :] = 0  # a few culled gaussians
    return means2d, radii, depths, tw, th


def _both(means2d, radii, depths, tw, th, **kw):
    want = jtiling.isect_tiles_packed(
        jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths),
        16, tw, th, **kw,
    )
    got = ttiling.isect_tiles_packed(
        torch.from_numpy(means2d), torch.from_numpy(radii),
        torch.from_numpy(depths), 16, tw, th, **kw,
    )
    return got, want


def _assert_same_stream(got, want, ordered=False):
    assert got.n_isects == int(want.n_isects)
    assert got.n_dropped == int(want.n_dropped)
    assert got.depth_bits == want.depth_bits
    assert got.isect_keys.shape[0] == want.isect_keys.shape[0]
    offs = got.offsets.numpy()
    np.testing.assert_array_equal(offs, np.asarray(want.offsets))
    fg, fw = got.flatten_ids.numpy(), np.asarray(want.flatten_ids)
    kg, kw = got.isect_keys.numpy(), np.asarray(want.isect_keys)
    for t in range(len(offs) - 1):
        s, e = offs[t], offs[t + 1]
        if ordered:
            np.testing.assert_array_equal(fg[s:e], fw[s:e])
        else:
            np.testing.assert_array_equal(np.sort(fg[s:e]), np.sort(fw[s:e]))
        # keys are the same multiset and sorted
        np.testing.assert_array_equal(kg[s:e], np.sort(kw[s:e]))


@pytest.mark.parametrize(
    "case",
    [
        dict(max_tiles_per_gauss=16),
        dict(max_tiles_per_gauss=4),  # the cap drops tiles of big gaussians
        dict(max_tiles_per_gauss=16, capacity=300),  # capacity truncation
        dict(max_tiles_per_gauss=64, I=2),
        dict(max_tiles_per_gauss=8, big=True),
    ],
    ids=["capped", "capped_k4", "capped_capacity", "capped_2images", "capped_big"],
)
def test_isect_capped_matches(case):
    case = dict(case)
    I, big = case.pop("I", 1), case.pop("big", False)
    got, want = _both(*_inputs(300, I=I, big=big), **case)
    _assert_same_stream(got, want)


@pytest.mark.parametrize(
    "case",
    [
        dict(),
        dict(capacity=200),  # demand beyond the capacity drops the tail
        dict(big=True),
    ],
    ids=["exact", "exact_capacity", "exact_big"],
)
def test_isect_exact_matches(case):
    case = dict(case)
    big = case.pop("big", False)
    got, want = _both(*_inputs(301, big=big), exact=True, **case)
    if "capacity" in case:
        assert got.n_dropped > 0
    _assert_same_stream(got, want)


@pytest.mark.parametrize("exact", [False, True])
def test_isect_exact_depth_order_matches(exact):
    got, want = _both(*_inputs(302, big=True), max_tiles_per_gauss=16,
                      exact=exact, exact_depth=True)
    assert got.depth_bits == 0
    _assert_same_stream(got, want, ordered=True)


def test_isect_split_k_raises():
    """split_k raised until the two-population expansion was ported; it now
    gives the JAX package's stream (tests/test_torch_isect_plan.py holds
    it in full), and split_k outside (0, K) is the capped expansion."""
    for split_k in (4, 16):
        got, want = _both(*_inputs(303, N=8), max_tiles_per_gauss=16, split_k=split_k)
        _assert_same_stream(got, want)


def test_isect_offset_encode_matches():
    rng = np.random.default_rng(304)
    keys = np.sort(rng.integers(0, 12, size=200)).astype(np.int32)
    got = ttiling.isect_offset_encode(torch.from_numpy(keys), 1, 4, 3)
    want = jtiling.isect_offset_encode(jnp.asarray(keys), 1, 4, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
