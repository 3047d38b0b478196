"""Port parity: the plain PyTorch compositor of
``tdgs_torch.ops.rasterize_packed`` against the Pallas
``rasterize_to_pixels_packed_inference`` (interpret mode on the CPU, as the
JAX package's own tests run it), over one shared stream from the JAX
package's projection and tiling.

Tolerance 2e-3 absolute, as test_packed_inference_matches_jax uses: the
Pallas kernel takes the transmittance prefix in log space and the plain
version with a cumprod, and the two round differently at the 1e-4 cutoff.
The CUDA kernel itself is held against the plain version on the card by
test_torch_kernel_card.py, on small streams and at full size."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops import tiling as jtiling
from tdgs.ops.projection import fully_fused_projection
from tdgs.ops.rasterize_pallas_packed import (
    rasterize_to_pixels_packed_inference as pallas_inference,
)
from tdgs_torch.ops import _build
from tdgs_torch.ops.rasterize_packed import (
    CUTOFFS,
    TRANSMITTANCE_EPS,
    left_to_right,
    max_entries_per_tile,
    pixel_entry_evaluations,
    rasterize_to_pixels_packed_inference,
    rasterize_to_pixels_packed_inference_plain,
)
from tests.test_rasterize import make_raster_inputs
from tests.test_torch_kernel_card import PREFIX_OPACITY, cutoff_stream, near_cutoff_opacities

ATOL = 2e-3


def _projected_stream(seed, N=64, width=64, height=48):
    """Screen-space gaussians + packed stream from the JAX package."""
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(N, 3)) + [0, 0, 5]).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, size=(N, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 1, size=(N,)).astype(np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None]
    Ks = np.array([[[60.0, 0, 32], [0, 60, 24], [0, 0, 1]]], np.float32)
    radii, means2d, depths, conics, _ = fully_fused_projection(
        jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
        jnp.asarray(viewmats), jnp.asarray(Ks), width, height,
        opacities=jnp.asarray(opac),
    )
    isect = jtiling.isect_tiles_packed(
        means2d, radii, depths, 16, 4, 3, max_tiles_per_gauss=32,
    )
    colors = rng.uniform(0, 1, size=(1, N, 3)).astype(np.float32)
    return dict(
        means2d=np.array(means2d), conics=np.array(conics),
        colors=colors, depths=np.array(depths),
        opacities=np.broadcast_to(opac, (1, N)).copy(),
        offsets=np.array(isect.offsets), flatten_ids=np.array(isect.flatten_ids),
        width=width, height=height,
    )


def _raster_stream(seed, N, width, height, min_radius=0):
    """make_raster_inputs scene (random conics) tiled by the JAX package."""
    rng = np.random.default_rng(seed)
    means2d, conics, colors, opacities, radii, depths, tw, th = make_raster_inputs(
        rng, N=N, width=width, height=height
    )
    radii = np.maximum(radii, min_radius)
    isect = jtiling.isect_tiles_packed(
        jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths),
        16, tw, th, max_tiles_per_gauss=64,
    )
    return dict(
        means2d=means2d, conics=conics, colors=colors, opacities=opacities,
        offsets=np.array(isect.offsets), flatten_ids=np.array(isect.flatten_ids),
        width=width, height=height,
    )


def _compare(s, colors, backgrounds=None, tile_capacity=1024):
    args = (s["means2d"], s["conics"], colors, s["opacities"])
    want_c, want_a = pallas_inference(
        *map(jnp.asarray, args), s["width"], s["height"], 16,
        jnp.asarray(s["offsets"]), jnp.asarray(s["flatten_ids"]),
        backgrounds=None if backgrounds is None else jnp.asarray(backgrounds),
        tile_capacity=tile_capacity,
    )
    got_c, got_a = rasterize_to_pixels_packed_inference_plain(
        *map(torch.from_numpy, args), s["width"], s["height"], 16,
        torch.from_numpy(s["offsets"]), torch.from_numpy(s["flatten_ids"]),
        backgrounds=None if backgrounds is None else torch.from_numpy(backgrounds),
        tile_capacity=tile_capacity,
    )
    assert got_c.shape == want_c.shape and got_a.shape == want_a.shape
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=ATOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=ATOL)
    return got_c, got_a


@pytest.mark.parametrize("case", ["rgb", "rgb_depth", "background"])
def test_plain_matches_pallas_inference(case):
    s = _projected_stream(400)
    colors = s["colors"]
    bg = None
    if case == "rgb_depth":  # D = 4: RGB + depth, as render_mode RGB+D
        colors = np.concatenate([colors, s["depths"][..., None]], -1)
    if case == "background":
        bg = np.array([[0.2, 0.7, 0.4]], np.float32)
    c, a = _compare(s, colors, backgrounds=bg)
    assert float(a.max()) > 0.5  # the scene covers pixels


def test_plain_truncation_matches_pallas_inference():
    """Tiles whose raw ranges overflow tile_capacity=128 (the set-up of
    test_packed_truncation_matches_jax)."""
    s = _raster_stream(117, N=300, width=32, height=32, min_radius=24)
    assert (np.diff(s["offsets"]) > 128).sum() >= 2
    _compare(s, s["colors"], tile_capacity=128)


def test_plain_tile_capacity_keeps_whole_chunks():
    """tile_capacity=200 keeps max(200 // 128, 1)·128 = 128 entries a tile,
    as the TPU kernel does, not 200."""
    assert max_entries_per_tile(200) == 128
    s = _raster_stream(118, N=300, width=32, height=32, min_radius=24)
    counts = np.diff(s["offsets"])
    assert (counts > 200).sum() >= 2
    c200, a200 = _compare(s, s["colors"], tile_capacity=200)
    c128, a128 = rasterize_to_pixels_packed_inference_plain(
        *map(torch.from_numpy, (s["means2d"], s["conics"], s["colors"],
                                s["opacities"])),
        32, 32, 16, torch.from_numpy(s["offsets"]),
        torch.from_numpy(s["flatten_ids"]), tile_capacity=128,
    )
    torch.testing.assert_close(c200, c128, rtol=0, atol=0)
    torch.testing.assert_close(a200, a128, rtol=0, atol=0)


def test_wrapper_takes_plain_version_on_cpu():
    s = _projected_stream(401)
    args = [torch.from_numpy(s[k]) for k in ("means2d", "conics", "colors", "opacities")]
    ids = (torch.from_numpy(s["offsets"]), torch.from_numpy(s["flatten_ids"]))
    before = dict(_build.LAUNCHES)
    got = rasterize_to_pixels_packed_inference(*args, 64, 48, 16, *ids)
    want = rasterize_to_pixels_packed_inference_plain(*args, 64, 48, 16, *ids)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert _build.LAUNCHES == before  # no kernel launch on the CPU


def test_pixel_entry_evaluations_counts_the_walk():
    """Three opaque entries over a one-tile image: α = 0.999 leaves T = 1e-3
    after the first and 1e-6 after the second, so the second ends every
    pixel's walk, is walked but not live, and the third is never reached;
    faint entries are all walked and all live."""
    means2d = torch.full((1, 3, 2), 8.0)
    conics = torch.tensor([[[1e-4, 0.0, 1e-4]] * 3])
    colors = torch.ones((1, 3, 3))
    offsets = torch.tensor([0, 3], dtype=torch.int32)
    ids = torch.tensor([0, 1, 2], dtype=torch.int32)

    def evals(opacity, width=16, height=16):
        return pixel_entry_evaluations(
            means2d, conics, colors, torch.full((1, 3), opacity), width, height,
            16, offsets, ids,
        )

    assert evals(1.0) == (256 * 2, 256)
    assert evals(0.01) == (256 * 3, 256 * 3)
    assert evals(0.01, 10, 12) == (10 * 12 * 3,) * 2  # pixels outside are not walked


@pytest.mark.parametrize("cut", CUTOFFS)
def test_left_to_right_decides_cutoffs_as_the_kernels(cut):
    """Rows whose product of (1 − α) ends within ulps of a cutoff: on some,
    ``cumprod`` (float64 on the CPU) and the kernels' left-to-right float32
    product fall on two sides of it; ``left_to_right`` decides every entry
    of every row as the left-to-right product does, and takes its values
    on the rows it recomputes."""
    ops = near_cutoff_opacities(np.random.default_rng(11), 256, cut)
    one_minus = 1.0 - torch.from_numpy(ops)
    raw = torch.cumprod(one_minus, dim=-1)
    want = np.multiply.accumulate(np.float32(1) - ops, axis=-1, dtype=np.float32)
    assert ((raw.numpy() > np.float32(cut)) != (want > np.float32(cut))).any()
    got = left_to_right(raw.clone(), one_minus).numpy()
    for c in CUTOFFS:
        np.testing.assert_array_equal(got > np.float32(c), want > np.float32(c))
    moved = (got != raw.numpy()).any(-1)
    np.testing.assert_array_equal(got[moved], want[moved])


def test_plain_inclusion_multiplies_left_to_right():
    """Tiles whose last entry's product lands within ulps of the 1e-4
    cutoff, α = the opacity at every pixel (zero conics): the plain
    version includes each entry as a left-to-right float32 walk does (the
    kernels' walk, here in numpy), to 1e-6, though the last entry weighs
    α·T of about 1e-2."""
    assert PREFIX_OPACITY.keys() == set(CUTOFFS)
    ops = near_cutoff_opacities(np.random.default_rng(12), 64, TRANSMITTANCE_EPS)
    s = cutoff_stream(ops)
    got_c, got_a = rasterize_to_pixels_packed_inference_plain(
        s["means2d"], s["conics"], s["colors"], s["opacities"], s["width"], s["height"],
        16, s["offsets"], s["flatten_ids"])
    colors = s["colors"].numpy().reshape(ops.shape + (-1,))
    for t, row in enumerate(ops):
        T, acc = np.float32(1), np.zeros(colors.shape[-1])
        for k, a in enumerate(row):
            next_T = T * (np.float32(1) - a)
            if next_T <= np.float32(TRANSMITTANCE_EPS):
                break
            acc += float(a * T) * colors[t, k]
            T = next_T
        tile = np.s_[0, :, 16 * t:16 * (t + 1)]
        np.testing.assert_allclose(got_c[tile].numpy(), np.broadcast_to(acc, (16, 16, 3)),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_a[tile].numpy(), 1 - T, rtol=0, atol=1e-6)
