"""The port's index rasterizers and list compositing (``tdgs_torch.ops.
indices``) against the JAX package's (``tdgs/ops/indices.py``), on the
same tiled inputs from a seed (the JAX dense tiling, handed to both).

Index lists (gaussian, pixel, image ids and the validity mask): equal.
``accumulate``/``accumulate_2dgs`` outputs and gradients: within 1e-5
relative (max|Δ| ≤ 1e-5·max|JAX|), the JAX side jitted, on 16x16 scenes:
the JAX accumulate takes each ray's prefix as a difference of float32
prefix sums over the whole list, which loses ulp(|Σ log(1 − α)|), 2e-4 on
the dense scene's lists (ROADMAP, faults on the reference side). The port
takes them in float64 and keeps 1e-5 of its float64 evaluation there. The 2DGS cases
hand the JAX functions Mᵀ, since they read the ray transform's rows
(ROADMAP, faults on the reference side); the port reads its columns.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops import indices as J
from tdgs.ops import tiling as jtiling
from tdgs_torch.ops import indices as T
from tests.test_2dgs import make_surfel_scene
from tests.test_rasterize import make_raster_inputs

RTOL = 1e-5
W, H, TILE = 48, 32, 4  # 16-entry batches: several ranges a tile


def _rel_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= RTOL * scale, (name, np.abs(got - want).max(), scale)


def _tiles(means2d, radii, depths, I, width=W, height=H):
    tw, th = -(-width // TILE), -(-height // TILE)
    res = jtiling.isect_tiles(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths),
                              TILE, tw, th, capacity=1 << 12, max_tiles_per_gauss=64)
    offsets = jtiling.isect_offset_encode(res.isect_keys, I, tw, th)
    return np.asarray(offsets), np.asarray(res.flatten_ids), int(res.n_isects)


def _max_per_tile(tiles):
    offsets, _, n = tiles
    return int(np.diff(np.append(offsets.reshape(-1), n)).max())


def _lists_equal(got, want):
    for g, w, name in zip(got, want, ("gaussian_ids", "pixel_ids", "image_ids", "valid")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert int(np.asarray(want[3]).sum()) > 0


@pytest.fixture(scope="module")
def scene3d():
    rng = np.random.default_rng(150)
    means2d, conics, colors, opac, radii, depths, _, _ = make_raster_inputs(
        rng, I=2, N=128, width=W, height=H)
    tiles = _tiles(means2d, radii, depths, 2)
    trans = rng.uniform(0.05, 1.0, size=(2, H, W)).astype(np.float32)
    assert _max_per_tile(tiles) > 16  # entries past the first range
    return means2d, conics, colors, opac, tiles, trans


@pytest.mark.parametrize("rng_range", [(0, 1), (1, 2), (0, 4)])
def test_index_lists_equal(scene3d, rng_range):
    means2d, conics, _, opac, (offsets, fids, n), trans = scene3d
    a, b = rng_range
    want = jax.jit(J.rasterize_to_indices_in_range, static_argnums=(0, 1, 6, 7, 8))(
        a, b, jnp.asarray(trans), jnp.asarray(means2d), jnp.asarray(conics),
        jnp.asarray(opac), W, H, TILE, jnp.asarray(offsets), jnp.asarray(fids), n)
    got = T.rasterize_to_indices_in_range(
        a, b, torch.as_tensor(trans), torch.as_tensor(means2d), torch.as_tensor(conics),
        torch.as_tensor(opac), W, H, TILE, torch.as_tensor(offsets), torch.as_tensor(fids), n)
    _lists_equal(got, want)


def _small3d():
    """A 16x16 scene whose lists' |Σ log(1 − α)| stays small: the JAX
    accumulate's float32 prefix differences keep 1e-5 there."""
    rng = np.random.default_rng(152)
    means2d, conics, colors, opac, radii, depths, _, _ = make_raster_inputs(
        rng, I=1, N=6, width=16, height=16)
    offsets, fids, n = _tiles(means2d, radii, depths, 1, width=16, height=16)
    lists = J.rasterize_to_indices_in_range(
        0, 4, jnp.ones((1, 16, 16)), jnp.asarray(means2d), jnp.asarray(conics),
        jnp.asarray(opac), 16, 16, TILE, jnp.asarray(offsets), jnp.asarray(fids),
        jnp.asarray(n))
    return (means2d, conics, opac, colors), lists


def _accumulate_pair(j_fn, t_fn, ins, j_ins, lists, size, transpose=None):
    """(port, JAX) renders, alphas and input gradients of a random linear
    loss of both outputs."""
    g, p, i, v = lists
    I = ins[0].shape[0] if ins[0].ndim == 3 else 1
    rng = np.random.default_rng(3)
    w_img = rng.normal(size=(I, size, size, ins[-1].shape[-1])).astype(np.float32)
    w_alpha = rng.normal(size=(I, size, size, 1)).astype(np.float32)

    @jax.jit
    def j_loss(*xs):
        rend, alph = j_fn(*xs, g, p, i, size, size, valid=v)
        return jnp.sum(rend * w_img) + jnp.sum(alph * w_alpha), (rend, alph)

    (_, want_out), want_g = jax.value_and_grad(
        j_loss, argnums=tuple(range(len(ins))), has_aux=True)(*map(jnp.asarray, j_ins))
    leaves = [torch.as_tensor(x).requires_grad_(True) for x in ins]
    out = t_fn(*leaves, *(torch.as_tensor(np.asarray(x)) for x in (g, p, i)), size, size,
               valid=torch.as_tensor(np.asarray(v)))
    loss = (out[0] * torch.as_tensor(w_img)).sum() + (out[1] * torch.as_tensor(w_alpha)).sum()
    got_g = list(torch.autograd.grad(loss, leaves))
    if transpose is not None:
        got_g[transpose] = got_g[transpose].transpose(-1, -2)
    return [o.detach() for o in out], want_out, got_g, want_g


def test_accumulate_matches_jax():
    ins, lists = _small3d()
    got, want, got_g, want_g = _accumulate_pair(J.accumulate, T.accumulate, ins, ins, lists, 16)
    _rel_close(got[0], want[0], "renders")
    _rel_close(got[1], want[1], "alphas")
    for name, a, b in zip(("means2d", "conics", "opacities", "colors"), got_g, want_g):
        _rel_close(a, b, name)


def test_accumulate_keeps_precision_on_long_lists(scene3d):
    """On the dense scene's 196,608-entry lists the port's float32
    accumulate stays within 1e-5 of its float64 evaluation (the JAX
    package's float32 prefix differences are off by 2e-4 there)."""
    means2d, conics, colors, opac, (offsets, fids, n), _ = scene3d
    lists = T.rasterize_to_indices_in_range(
        0, 4, torch.ones((2, H, W)), *(torch.as_tensor(x) for x in (means2d, conics, opac)),
        W, H, TILE, torch.as_tensor(offsets), torch.as_tensor(fids), n)
    f32 = T.accumulate(*(torch.as_tensor(x) for x in (means2d, conics, opac, colors)),
                       *lists[:3], W, H, valid=lists[3])
    f64 = T.accumulate(*(torch.as_tensor(x).double() for x in (means2d, conics, opac, colors)),
                       *lists[:3], W, H, valid=lists[3])
    for a, b, name in zip(f32, f64, ("renders", "alphas")):
        _rel_close(a, b.float(), name)


@pytest.fixture(scope="module")
def scene2d():
    from tdgs.ops.projection_2dgs import fully_fused_projection_2dgs

    rng = np.random.default_rng(160)
    means, quats, scales, opac, colors, viewmats, Ks, width, height = make_surfel_scene(
        rng, N=96, C=1)
    radii, means2d, depths, M, _ = fully_fused_projection_2dgs(
        *map(jnp.asarray, (means, quats, scales, viewmats, Ks)), width, height)
    tiles = _tiles(np.asarray(means2d), np.asarray(radii), np.asarray(depths), 1,
                   width=width, height=height)
    op_c = np.broadcast_to(opac[None], means2d.shape[:-1]).copy()
    trans = rng.uniform(0.05, 1.0, size=(1, height, width)).astype(np.float32)
    assert _max_per_tile(tiles) > 16
    return np.asarray(means2d), np.asarray(M), op_c, tiles, trans, (width, height)


@pytest.mark.parametrize("rng_range", [(0, 1), (1, 3)])
def test_index_lists_2dgs_equal(scene2d, rng_range):
    means2d, M, opac, (offsets, fids, n), trans, (w, h) = scene2d
    a, b = rng_range
    want = jax.jit(J.rasterize_to_indices_in_range_2dgs, static_argnums=(0, 1, 6, 7, 8))(
        a, b, jnp.asarray(trans), jnp.asarray(means2d), jnp.swapaxes(jnp.asarray(M), -1, -2),
        jnp.asarray(opac), w, h, TILE, jnp.asarray(offsets), jnp.asarray(fids), n)
    got = T.rasterize_to_indices_in_range_2dgs(
        a, b, torch.as_tensor(trans), torch.as_tensor(means2d), torch.as_tensor(M),
        torch.as_tensor(opac), w, h, TILE, torch.as_tensor(offsets), torch.as_tensor(fids), n)
    _lists_equal(got, want)


def test_accumulate_2dgs_matches_jax():
    """On a 16x16 surfel scene (see ``_small3d``), Mᵀ to JAX."""
    from tdgs.ops.projection_2dgs import fully_fused_projection_2dgs

    rng = np.random.default_rng(161)
    means, quats, scales, opac, colors, viewmats, Ks, _, _ = make_surfel_scene(rng, N=6, C=1)
    Ks = Ks * np.array([1 / 4, 1 / 3, 1], np.float32)[:, None]  # 64x48 → 16x16
    radii, means2d, depths, M, _ = fully_fused_projection_2dgs(
        *map(jnp.asarray, (means, quats, scales, viewmats, Ks)), 16, 16)
    offsets, fids, n = _tiles(np.asarray(means2d), np.asarray(radii), np.asarray(depths), 1,
                              width=16, height=16)
    means2d, M = np.asarray(means2d), np.asarray(M)
    Mt = np.swapaxes(M, -1, -2)
    op_c = np.broadcast_to(opac[None], means2d.shape[:-1]).copy()
    col_c = np.broadcast_to(colors[None], means2d.shape[:-1] + (3,)).copy()
    lists = J.rasterize_to_indices_in_range_2dgs(
        0, 4, jnp.ones((1, 16, 16)), jnp.asarray(means2d), jnp.asarray(Mt), jnp.asarray(op_c),
        16, 16, TILE, jnp.asarray(offsets), jnp.asarray(fids), jnp.asarray(n))
    assert int(np.asarray(lists[3]).sum()) > 0
    got, want, got_g, want_g = _accumulate_pair(
        J.accumulate_2dgs, T.accumulate_2dgs, (means2d, M, op_c, col_c),
        (means2d, Mt, op_c, col_c), lists, 16, transpose=1)
    _rel_close(got[0], want[0], "renders")
    _rel_close(got[1], want[1], "alphas")
    for name, a, b in zip(("means2d", "ray_transforms", "opacities", "colors"), got_g, want_g):
        _rel_close(a, b, name)
