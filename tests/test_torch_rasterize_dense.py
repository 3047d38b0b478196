"""Port parity of the tile-dense path against the JAX package: the dense
tiling (``isect_tiles``, ``count_isects``, ``derive_isect_capacity``), the
jnp oracle's pieces (``gather_tile_gaussians``, ``composite_prefix``), both
dense rasterizers (the port's ``rasterize_to_pixels_jax`` and
``rasterize_to_pixels_pallas``, whose kernels 9 and 10 take their plain
versions on the CPU) against both JAX rasterizers (Pallas in interpret
mode), and the masked ``gather_rows_segsum``. The rasterizers get the same
stream: the JAX package's tiling, handed to both.

Tolerances:
- tiling: keys, depths, ids and counts equal, slot for slot;
- the port's rasterizers against the JAX ``"jax"`` rasterizer, the same
  cumprod formulation: forward max|Δ| ≤ 1e-5, gradients max|Δ| ≤ 1e-4 ·
  max|ref| per input;
- against the JAX ``"pallas"`` kernels, which decide inclusion in log
  space (log1p, a triangular matmul) where the port keeps a running
  product: forward max|Δ| ≤ 1e-4 and gradients ≤ 1e-3 · max|ref| on these
  scenes, whose pixels do not sit at the 1e-4 cutoff; the JAX package's
  own test of the two (tests/test_rasterize_pallas.py) allows 2e-3 and
  2e-2, for scenes where a pixel may flip by one slot;
- kernel 10's plain rows against the JAX backward kernel's per-slot
  outputs on the same gathered slots: max|Δ| ≤ 1e-4 · max|ref| per group.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops import rasterize_jax as JR
from tdgs.ops import rasterize_pallas as JP
from tdgs.ops import tiling as jtiling
from tdgs.ops.projection import fully_fused_projection as j_project
from tdgs_torch.ops import _build
from tdgs_torch.ops import rasterize_jax as TR
from tdgs_torch.ops import rasterize_pallas as TP
from tdgs_torch.ops import tiling as ttiling
from tdgs_torch.ops.projection import fully_fused_projection as t_project
from tdgs_torch.ops.segment_sum import gather_rows_segsum
from tests import oracles
from tests.test_rasterize import make_raster_inputs

NAMES = ("means2d", "conics", "colors", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# dense tiling
# ---------------------------------------------------------------------------


def _tiling_inputs(case):
    rng = np.random.default_rng({"plain": 1, "max_tiles_cut": 2, "capacity_overflow": 3,
                                 "two_images": 4, "depth_ties": 5, "negative_depths": 6}[case])
    I = 2 if case == "two_images" else 1
    means2d, _, _, _, radii, depths, tw, th = make_raster_inputs(
        rng, I=I, N=60, width=80, height=48)
    radii[..., :4, :] = 0  # culled gaussians
    if case in ("max_tiles_cut", "capacity_overflow"):
        radii[..., 4:20, :] = 30  # footprints of many tiles
    if case == "depth_ties":
        depths = np.round(depths).astype(np.float32)  # many equal depths
    if case == "negative_depths":
        depths = (depths - 5.0).astype(np.float32)
        depths[..., 10] = -0.0
        depths[..., 11] = 0.0
    K = {"max_tiles_cut": 4}.get(case, 64)
    total = sum(min(int(n), K) for n in _full_counts(means2d, radii, tw, th))
    capacity = total // 2 if case == "capacity_overflow" else total + 40
    return means2d, radii, depths, tw, th, capacity, K


def _full_counts(means2d, radii, tw, th):
    out = []
    for m, r in zip(means2d.reshape(-1, 2), radii.reshape(-1, 2)):
        if (r <= 0).any():
            out.append(0)
            continue
        lo = np.clip(np.floor((m - r) / 16), 0, [tw, th])
        hi = np.clip(np.ceil((m + r) / 16), 0, [tw, th])
        out.append(int(np.prod(hi - lo)))
    return out


@pytest.mark.parametrize("case", ["plain", "max_tiles_cut", "capacity_overflow",
                                  "two_images", "depth_ties", "negative_depths"])
def test_isect_tiles_matches_jax(case):
    means2d, radii, depths, tw, th, capacity, K = _tiling_inputs(case)
    want = jtiling.isect_tiles(jnp.asarray(means2d), jnp.asarray(radii),
                               jnp.asarray(depths), 16, tw, th, capacity=capacity,
                               max_tiles_per_gauss=K)
    got = ttiling.isect_tiles(_t(means2d), _t(radii), _t(depths), 16, tw, th,
                              capacity=capacity, max_tiles_per_gauss=K)
    assert got.n_isects == int(want.n_isects)
    assert got.n_dropped == int(want.n_dropped)
    if case in ("max_tiles_cut", "capacity_overflow"):
        assert got.n_dropped > 0
    for name in ("tiles_per_gauss", "isect_keys", "isect_depths", "flatten_ids"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        # bit for bit (the depths' −0.0 and +0.0 included)
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=name)
    if case == "plain":
        # and the brute-force numpy enumeration (stable on ties)
        entries = oracles.isect_tiles_np(means2d, radii, depths, 16, tw, th)
        n = got.n_isects
        assert n == len(entries)
        np.testing.assert_array_equal(got.isect_keys[:n].numpy(), [e[0] for e in entries])
        np.testing.assert_array_equal(got.flatten_ids[:n].numpy(), [e[2] for e in entries])


def test_isect_tiles_unsorted_keeps_enumeration_order():
    means2d, radii, depths, tw, th, capacity, K = _tiling_inputs("capacity_overflow")
    want = jtiling.isect_tiles(jnp.asarray(means2d), jnp.asarray(radii),
                               jnp.asarray(depths), 16, tw, th, capacity=capacity,
                               max_tiles_per_gauss=K, sort=False)
    got = ttiling.isect_tiles(_t(means2d), _t(radii), _t(depths), 16, tw, th,
                              capacity=capacity, max_tiles_per_gauss=K, sort=False)
    for name in ("isect_keys", "isect_depths", "flatten_ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def _scene(seed, N=300):
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(N, 3)) * [1.5, 1.0, 1.0] + [0, 0, 4]).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.4, size=(N, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 1.0, size=(N,)).astype(np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None]
    Ks = np.array([[[70.0, 0, 40], [0, 70.0, 24], [0, 0, 1]]], np.float32)
    return means, quats, scales, opac, viewmats, Ks


@pytest.mark.parametrize("K", [None, 16])
def test_count_isects_and_derive_isect_capacity_match_jax(K):
    means, quats, scales, opac, viewmats, Ks = _scene(11)
    radii, means2d, _, _, _ = j_project(*map(jnp.asarray, (means, quats, scales, viewmats,
                                                          Ks)), 80, 48,
                                        opacities=jnp.asarray(opac))
    want = jtiling.count_isects(means2d, radii, 16, 5, 3, max_tiles_per_gauss=K)
    got = ttiling.count_isects(_t(means2d), _t(radii), 16, 5, 3, max_tiles_per_gauss=K)
    assert got == tuple(int(x) for x in want)
    kw = dict(max_tiles_per_gauss=K, headroom=1.3)
    j_cap = jtiling.derive_isect_capacity(*map(jnp.asarray, (means, quats, scales, opac,
                                                             viewmats, Ks)), 80, 48, **kw)
    t_cap = ttiling.derive_isect_capacity(means, quats, scales, opac, viewmats, Ks, 80, 48,
                                          device="cpu", **kw)
    assert t_cap == j_cap
    # the port's own projection gives the same counts
    r2, m2, _, _, _ = t_project(*map(_t, (means, quats, scales, viewmats, Ks)), 80, 48,
                                opacities=_t(opac))
    assert ttiling.count_isects(m2, r2, 16, 5, 3, max_tiles_per_gauss=K) == got


# ---------------------------------------------------------------------------
# the jnp oracle's pieces
# ---------------------------------------------------------------------------


def _stream(seed, I=1, N=32, width=48, height=32, opaque=False, big=False):
    """A JAX-tiled stream: (inputs as numpy, offsets [I, th, tw], flatten
    ids, n_isects), as tests/test_rasterize_pallas.py builds it."""
    rng = np.random.default_rng(seed)
    means2d, conics, colors, opac, radii, depths, tw, th = make_raster_inputs(
        rng, I=I, N=N, width=width, height=height, opaque=opaque)
    if big:  # wide footprints: every gaussian over every tile
        conics = (conics * 0.05).astype(np.float32)
        radii = np.maximum(radii, 48)
    entries = oracles.isect_tiles_np(means2d, radii, depths, 16, tw, th)
    res = jtiling.isect_tiles(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths),
                              16, tw, th, capacity=len(entries) + 8, max_tiles_per_gauss=64)
    offsets = jtiling.isect_offset_encode(res.isect_keys, I, tw, th)
    inputs = [means2d, conics, colors, opac]
    return inputs, np.asarray(offsets), np.asarray(res.flatten_ids), int(res.n_isects), \
        (width, height)


def test_gather_tile_gaussians_and_composite_prefix_match_jax():
    inputs, offsets, fids, n, _ = _stream(21, I=2)
    for cap in (128, 8):  # 8 cuts the fullest tiles
        want_ids, want_valid = JR.gather_tile_gaussians(jnp.asarray(offsets),
                                                        jnp.asarray(fids), jnp.asarray(n), cap)
        got_ids, got_valid = TR.gather_tile_gaussians(_t(offsets), _t(fids), n, cap)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    rng = np.random.default_rng(22)
    alphas = np.where(rng.uniform(size=(5, 7, 40)) < 0.3, 0.0,
                      rng.uniform(0.0, 0.999, size=(5, 7, 40))).astype(np.float32)
    colors = rng.uniform(size=(5, 7, 40, 3)).astype(np.float32)
    want = JR.composite_prefix(jnp.asarray(alphas), jnp.asarray(colors))
    got = TR.composite_prefix(_t(alphas), _t(colors))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the dense rasterizers
# ---------------------------------------------------------------------------

CASES = {
    "background": dict(seed=41, N=24, bg=True, cap=128),
    "two_images": dict(seed=42, I=2, N=20, bg=False, cap=128),
    "truncating": dict(seed=43, N=160, big=True, width=32, height=32, bg=True, cap=128),
}


def _case(name):
    kw = dict(CASES[name])
    bg, cap = kw.pop("bg"), kw.pop("cap")
    inputs, offsets, fids, n, (W, H) = _stream(**kw)
    I = inputs[0].shape[0]
    rng = np.random.default_rng(kw["seed"] + 100)
    bgs = rng.uniform(size=(I, 3)).astype(np.float32) if bg else None
    tgt = rng.uniform(size=(I, H, W, 3)).astype(np.float32)
    return inputs, offsets, fids, n, W, H, bgs, tgt, cap


@functools.lru_cache(maxsize=None)
def _jax_reference(name, which):
    """(image, alpha, gradients) of the JAX rasterizer ``which`` on case
    ``name``, jitted; loss Σ(img − tgt)² + 0.1 Σ alpha."""
    inputs, offsets, fids, n, W, H, bgs, tgt, cap = _case(name)
    fn = JR.rasterize_to_pixels_jax if which == "jax" else JP.rasterize_to_pixels_pallas
    bg = None if bgs is None else jnp.asarray(bgs)

    def render(m, c, col, op):
        return fn(m, c, col, op, W, H, 16, jnp.asarray(offsets), jnp.asarray(fids),
                  jnp.asarray(n), backgrounds=bg, tile_capacity=cap)

    def loss(*xs):
        img, alpha = render(*xs)
        return jnp.sum((img - jnp.asarray(tgt)) ** 2) + 0.1 * jnp.sum(alpha), (img, alpha)

    grads, (img, alpha) = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, inputs))
    return np.asarray(img), np.asarray(alpha), [np.asarray(g) for g in grads]


def _port(name, which):
    inputs, offsets, fids, n, W, H, bgs, tgt, cap = _case(name)
    fn = TR.rasterize_to_pixels_jax if which == "jax" else TP.rasterize_to_pixels_pallas
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    img, alpha = fn(*leaves, W, H, 16, _t(offsets), _t(fids), n,
                    backgrounds=None if bgs is None else _t(bgs), tile_capacity=cap)
    loss = ((img - _t(tgt)) ** 2).sum() + 0.1 * alpha.sum()
    grads = torch.autograd.grad(loss, leaves)
    return img.detach().numpy(), alpha.detach().numpy(), [g.numpy() for g in grads]


def _assert_rel(got, want, rtol, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max|Δ| {err} > {rtol} · {scale}"


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("port", ["jax", "pallas"])
def test_dense_rasterizers_match_both_jax_rasterizers(port, case):
    img, alpha, grads = _port(case, port)
    assert np.isfinite(img).all() and all(np.isfinite(g).all() for g in grads)
    if case == "truncating":
        counts = np.diff(np.append(_case(case)[1].reshape(-1), _case(case)[3]))
        assert counts.max() > CASES[case]["cap"]  # some tile is cut
    for which, atol, rtol in (("jax", 1e-5, 1e-4), ("pallas", 1e-4, 1e-3)):
        w_img, w_alpha, w_grads = _jax_reference(case, which)
        np.testing.assert_allclose(img, w_img, rtol=0, atol=atol, err_msg=which)
        np.testing.assert_allclose(alpha, w_alpha, rtol=0, atol=atol, err_msg=which)
        for nm, g, w in zip(NAMES, grads, w_grads):
            _assert_rel(g, w, rtol, f"{which}/{nm}")


def test_kernel10_plain_rows_match_the_jax_backward_kernel():
    """The plain version of kernel 10 against ``_raster_core``'s backward
    (the Pallas ``_bwd_kernel`` in interpret mode) on the same gathered
    slots and cotangents, slot for slot."""
    inputs, offsets, fids, n, W, H, _, _, cap = _case("truncating")
    m2, con, col, op = (x.reshape(-1, x.shape[-1]) if x.ndim == 3 else x.reshape(-1)
                        for x in inputs)
    ids, valid = JR.gather_tile_gaussians(jnp.asarray(offsets), jnp.asarray(fids),
                                          jnp.asarray(n), cap)
    g = [jnp.swapaxes(jnp.asarray(x)[ids], 1, 2) for x in (m2, con, col)]
    g_op = jnp.where(valid, jnp.asarray(op)[ids], 0.0)[:, None, :]
    P = 256
    T = ids.shape[0]
    rng = np.random.default_rng(5)
    v_c = rng.normal(size=(T, 3, P)).astype(np.float32)
    v_t = rng.normal(size=(T, 1, P)).astype(np.float32)
    core = functools.partial(JP._raster_core, tile_size=16, tile_width=2, tiles_per_image=4)
    (c_out, t_out), vjp = jax.vjp(lambda *a: core(*a), *g, g_op)
    want = vjp((jnp.asarray(v_c), jnp.asarray(v_t)))  # [T, k, cap] each

    rows = torch.cat([_t(np.swapaxes(np.asarray(x), 1, 2)) for x in (g[0], g[1])]
                     + [_t(np.asarray(g_op)).transpose(1, 2), _t(np.swapaxes(np.asarray(g[2]), 1, 2))],
                     dim=-1).contiguous()
    counts = _t(np.asarray(valid).sum(1).astype(np.int32))
    img, trans = TP.rasterize_dense_fwd_plain(rows, counts, 1, W, H, 16)
    # the JAX kernel's per-tile outputs against the port's images
    np.testing.assert_allclose(img.numpy().reshape(1, 2, 16, 2, 16, 3).transpose(
        0, 1, 3, 5, 2, 4).reshape(T, 3, P), np.asarray(c_out), atol=1e-4)

    def per_pixel(x):  # [T, k, P] → [1, H, W, k]
        return _t(np.asarray(x).reshape(2, 2, -1, 16, 16).transpose(0, 3, 1, 4, 2).reshape(
            1, H, W, -1))

    v_rows = TP.rasterize_dense_bwd_plain(rows, counts, 1, W, H, 16, img, trans,
                                          per_pixel(v_c), per_pixel(v_t)[..., 0])
    for nm, cols, w in (("means2d", slice(0, 2), want[0]), ("conics", slice(2, 5), want[1]),
                        ("opacities", slice(5, 6), want[3]), ("colors", slice(6, 9), want[2])):
        _assert_rel(v_rows[..., cols].numpy(), np.swapaxes(np.asarray(w), 1, 2), 1e-4, nm)
    assert not v_rows[~_t(np.asarray(valid))].any()  # nothing past the counts


def test_tile_capacity_must_be_a_multiple_of_128():
    inputs, offsets, fids, n, (W, H) = _stream(51)
    with pytest.raises(ValueError, match="multiple of 128"):
        TP.rasterize_to_pixels_pallas(*map(_t, inputs), W, H, 16, _t(offsets), _t(fids), n,
                                      tile_capacity=100)


def test_cpu_path_launches_no_kernel():
    before = dict(_build.LAUNCHES)
    _port("background", "pallas")
    _port("background", "jax")
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("n_tiles,most,want", [
    (8160, 8, 1),  # 1080p: one block a tile
    (64, 8, 4),  # image fitting: 256 blocks on 132 SMs
    (9, 8, 8),  # capped at the tile's 8 warps or ranges
    (25, 2, 2),  # 8-pixel tiles: 2 warps a tile
    (200, 8, 1),
])
def test_split_count_from_tiles_and_sms(monkeypatch, n_tiles, most, want):
    """Kernels 9 and 10 cut each tile into the most blocks (a power of two,
    at most ``most``) that keep the launch within two blocks per SM; the
    card's SM count is read from its properties (132 on an H100)."""
    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    assert TP.split_count(n_tiles, "cuda", most) == want


# ---------------------------------------------------------------------------
# the masked gather and its segment-sum VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_n_valid", [False, True])
def test_masked_gather_rows_segsum(with_n_valid):
    rng = np.random.default_rng(61)
    n_rows, E, F = 30, 400, 5
    feats = rng.normal(size=(n_rows, F)).astype(np.float32)
    ids = rng.integers(0, n_rows, size=E).astype(np.int32)
    mask = rng.uniform(size=E) < 0.6
    n_valid = 300 if with_n_valid else E
    v = rng.normal(size=(E, F)).astype(np.float32)
    leaf = torch.tensor(feats, requires_grad=True)
    rows = gather_rows_segsum(leaf, _t(ids), torch.tensor(n_valid) if with_n_valid else None,
                              mask=_t(mask))
    np.testing.assert_array_equal(rows.detach().numpy(), feats[ids])
    (grad,) = torch.autograd.grad((rows * _t(v)).sum(), [leaf])
    keep = mask & (np.arange(E) < n_valid)
    want = np.zeros((n_rows, F), np.float64)
    np.add.at(want, ids[keep], v[keep])
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-5, atol=1e-5)
