"""The bound with which kernels 4, 5 and 6 cull 2DGS (surfel) entries per
warp (``tdgs_torch/csrc/surfel_cull.cuh``), held on the CPU through a
float32 PyTorch mirror of its ``may_reach``: over the box of the warp's
pixel centres, sigma2d >= 2 d^2 (d the distance from the surfel's centre
to the box) and sigma3d >= (lx^2 + ly^2) / hz^2 (lx, ly the least |tmpx|,
|tmpy| and hz the largest |tmpz| over the box's corners, tmp being affine
in the pixel centre), against log(255 op) + 1, with the header's slack.

On seeded warps of 32 pixel centres (tiles 16 and 8 pixels wide, so boxes
of 16 x 2 and 8 x 4 centres) and surfels placed about each warp -- the
bench scene's surfels projected by the port, and adversarial layouts:
edge-on surfels whose tmpz changes sign across the box, |tmpz| < 1e-9, op
at 1/255, surfels far larger than the tile, surfels grazing the threshold
-- it checks that the bound is sound: it never drops an entry at which the
plain ``_response_2dgs`` gives alpha >= 1/255 at a pixel centre of the
warp. Rows with NaN are kept wherever the kernels' walk (whose fminf takes
the other operand of a NaN) would include them. And the bound is not
vacuous: it drops nearly every surfel whose footprint lies clear of the
warp's box. The kernels' own agreement is held on the card by
``tests/test_torch_kernel_card.py``: against the plain version on layouts
that graze the bound, and at full size.
"""

import math

import numpy as np
import pytest
import torch

from tdgs_torch.ops import rasterize_2dgs_packed as R
from tdgs_torch.ops.projection_2dgs import fully_fused_projection_2dgs

THRESHOLD = np.float32(1.0 / 255.0)
WIDTH, HEIGHT, FOCAL = 1920, 1080, 1400.0
SIGMA_BAD = 1e6


def may_reach(g, box):
    """surfel_cull.cuh ``may_reach`` of entries ``g`` [W, K, 12] (mx, my, t0,
    tpx, tpy, op) against the warps' boxes (x0, x1, y0, y1) [W] → [W, K]
    bool; fmaxf and fminf as torch.fmax and torch.fmin (a NaN operand gives
    the other)."""
    x0, x1, y0, y1 = (b[:, None] for b in box)
    zero = torch.zeros((), dtype=torch.float32)
    fmax, fmin = torch.fmax, torch.fmin
    mx, my = g[..., 0], g[..., 1]
    dx = fmax(zero, fmax(x0 - mx, mx - x1))
    dy = fmax(zero, fmax(y0 - my, my - y1))
    s2d = 2.0 * (dx * dx + dy * dy)
    ax, ay = fmax(x0.abs(), x1.abs()), fmax(y0.abs(), y1.abs())
    lo = []
    for i in range(3):
        t, u, v = g[..., 2 + i], g[..., 5 + i], g[..., 8 + i]
        c = [t + u * x + v * y for x, y in ((x0, y0), (x1, y0), (x0, y1), (x1, y1))]
        lo_c = fmin(fmin(c[0], c[1]), fmin(c[2], c[3]))
        hi_c = fmax(fmax(c[0], c[1]), fmax(c[2], c[3]))
        slack = 1e-5 * (t.abs() + u.abs() * ax + v.abs() * ay)
        if i < 2:
            lo.append(fmax(zero, fmax(lo_c, -hi_c) - slack))
        else:
            hz = fmax(lo_c.abs(), hi_c.abs()) + slack
    s3d = fmin((lo[0] * lo[0] + lo[1] * lo[1]) / (hz * hz), torch.tensor(SIGMA_BAD))
    return ~(0.5 * fmin(s3d, s2d) * (1.0 - 1e-5) > torch.log(255.0 * g[..., 11]) + 1.0)


def _warps(tile_size, rng, n_warps):
    """Pixel centres [W, 32] of random warps of a 1920x1080 image's tiles,
    and their boxes."""
    tw, th = math.ceil(WIDTH / tile_size), math.ceil(HEIGHT / tile_size) - 1
    tile = rng.integers(0, tw * th, n_warps)
    warp = rng.integers(0, tile_size * tile_size // 32, n_warps)
    p = warp[:, None] * 32 + np.arange(32)
    px = (tile % tw * tile_size)[:, None] + p % tile_size + 0.5
    py = (tile // tw * tile_size)[:, None] + p // tile_size + 0.5
    px, py = (torch.as_tensor(x, dtype=torch.float32) for x in (px, py))
    return px, py, (px.amin(1), px.amax(1), py.amin(1), py.amax(1))


def _rows(c, A, m2, op):
    """Geometry rows [..., 12] of surfels with tmp = M (px, py, 1):
    M[:2] = [A, -A c], M[2] = m2."""
    M = np.zeros(c.shape[:-1] + (3, 3))
    M[..., :2, :2] = A
    M[..., :2, 2] = -np.einsum("...ij,...j->...i", A, c)
    M[..., 2, :] = m2
    g = np.concatenate([c, M[..., :, 2], M[..., :, 0], M[..., :, 1], op[..., None]], -1)
    return torch.as_tensor(g, dtype=torch.float32)


def _about(rng, px, py, K, spread):
    """Centres [W, K, 2] within ``spread`` pixels of each warp's box."""
    cx, cy = px.mean(1).numpy()[:, None], py.mean(1).numpy()[:, None]
    W = px.shape[0]
    return np.stack([cx + rng.uniform(-spread, spread, (W, K)),
                     cy + rng.uniform(-spread, spread, (W, K))], -1)


def _shapes(rng, W, K, size, iso=False):
    """A = rot(th) diag(stretch) / size [W, K, 2, 2]."""
    th = rng.uniform(0, np.pi, (W, K))
    rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                    np.stack([np.sin(th), np.cos(th)], -1)], -2)
    stretch = np.ones((W, K, 2)) if iso else rng.uniform(0.3, 3.0, (W, K, 2))
    return rot * (stretch / size[..., None])[..., None, :]


def _projected(rng, px, py, K, n=60_000):
    """The bench scene's surfels (means N(0, 1)·(3, 2, 1) + (0, 0, 8),
    scales 0.005-0.03, random rotations, op 0.3-1) projected by the port
    at 1920x1080: for each warp the K nearest to its box."""
    means = rng.normal(size=(n, 3)) * [3.0, 2.0, 1.0] + [0, 0, 8.0]
    quats = rng.normal(size=(n, 4))
    scales = rng.uniform(0.005, 0.03, size=(n, 3))
    opac = rng.uniform(0.3, 1.0, size=(1, n))
    Ks = np.array([[[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]]])
    t32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    radii, means2d, _, M, normals = fully_fused_projection_2dgs(
        t32(means), t32(quats), t32(scales), t32(np.eye(4)[None]), t32(Ks), WIDTH, HEIGHT)
    feats = R.feature_rows(means2d, M, torch.zeros((1, n, 1)), normals, t32(opac))
    seen = torch.nonzero((radii > 0).all(-1)[0])[:, 0]
    centre = torch.stack([px.mean(1), py.mean(1)], -1)  # [W, 2]
    d = (means2d[0, seen][None] - centre[:, None]).abs().amax(-1)  # [W, n_seen]
    near = seen[torch.topk(d, K, largest=False).indices]  # [W, K]
    return feats[near][..., :12]


def _layout(name, rng, px, py, K):
    """Surfels placed about each warp: geometry rows [W, K, 12]."""
    W = px.shape[0]
    if name == "projected":
        return _projected(rng, px, py, K)
    c = _about(rng, px, py, K, 24.0)
    size = rng.uniform(0.8, 6.0, (W, K))
    op = rng.uniform(0.05, 0.95, (W, K))
    tilt = rng.uniform(-0.01, 0.01, (W, K, 2))
    m2 = np.concatenate([tilt, 1.0 - (tilt * c).sum(-1, keepdims=True)], -1)
    A = _shapes(rng, W, K, size)
    if name == "edge_on":
        # tmpz = s (n . (p - c) + e): zero on a line within 2 pixels of the
        # centre, so it changes sign across most boxes it nears
        phi = rng.uniform(0, 2 * np.pi, (W, K))
        nrm = np.stack([np.cos(phi), np.sin(phi)], -1)
        s, e = rng.uniform(0.01, 1.0, (W, K, 1)), rng.uniform(-2, 2, (W, K, 1))
        m2 = s * np.concatenate([nrm, e - (nrm * c).sum(-1, keepdims=True)], -1)
    elif name == "tmpz_below_1e-9":
        # |tmpz| < 1e-9 wherever the surfel can be seen: constant, or
        # crossing zero at the centre
        flat = np.broadcast_to([0.0, 0.0, 3e-10], (W, K, 3))
        slope = np.stack([np.full((W, K), 1e-11), np.zeros((W, K)), -1e-11 * c[..., 0]], -1)
        m2 = np.where((np.arange(K) % 2 == 0)[None, :, None], flat, slope)
        size = rng.uniform(0.2, 3.0, (W, K))
        A = _shapes(rng, W, K, size)
    elif name == "op_at_threshold":
        # op = 1/255 on a pixel centre of the warp, just above it, and up
        # to 3 times it
        lane = rng.integers(0, 32, (W, K))
        on = np.stack([np.take_along_axis(px.numpy(), lane, 1),
                       np.take_along_axis(py.numpy(), lane, 1)], -1)
        c[:, 0::3] = on[:, 0::3]
        op[:, 0::3] = THRESHOLD
        op[:, 1::3] = np.nextafter(THRESHOLD, np.float32(1))
        op[:, 2::3] = rng.uniform(1.0, 3.0, op[:, 2::3].shape) / 255
    elif name == "far_larger_than_the_tile":
        c = _about(rng, px, py, K, 300.0)
        size = rng.uniform(30.0, 400.0, (W, K))
        A = _shapes(rng, W, K, size)
    elif name == "grazing":
        # round and facing the camera, sigma = d^2 / (2 size^2) at the
        # box's nearest point (d: 2-8 pixels) = log(255 op) + delta, so
        # alpha = exp(-delta) / 255 there: delta in [-0.3, 1.5] spans the
        # threshold and the bound's margin of 1
        ang = rng.uniform(0, 2 * np.pi, (W, K))
        x0, x1, y0, y1 = (b.numpy()[:, None] for b in (px.amin(1), px.amax(1),
                                                     py.amin(1), py.amax(1)))
        d = rng.uniform(2.0, 8.0, (W, K))
        near = np.stack([np.clip((x0 + x1) / 2 + 40 * np.cos(ang), x0, x1),
                         np.clip((y0 + y1) / 2 + 40 * np.sin(ang), y0, y1)], -1)
        c = near + d[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)
        delta = rng.uniform(-0.3, 1.5, (W, K))
        size = np.maximum(d / np.sqrt(2 * (np.log(255 * op) + delta)), 0.75)
        A = _shapes(rng, W, K, size, iso=True)
        m2 = np.broadcast_to([0.0, 0.0, 1.0], (W, K, 3))
    elif name != "random":
        raise ValueError(name)
    return _rows(c, A, m2, op)


def _reach(g, px, py):
    """[W, K]: whether the plain ``_response_2dgs`` gives alpha >= 1/255 at
    a pixel centre of the warp."""
    W, K, _ = g.shape
    ids = torch.arange(W * K).reshape(W, K)
    sigma, op, _ = R._response_2dgs(g.reshape(W * K, 12))(None, None, ids, px, py)
    alpha = torch.clamp(op * torch.exp(-sigma), max=0.999)
    return ((alpha >= torch.as_tensor(THRESHOLD)) & ~(sigma < 0)).any(1)


def _walk_reach(g, px, py):
    """_reach with the kernels' NaN semantics: their fminf gives the other
    operand of a NaN, so a NaN sigma3d leaves sigma2d, and a NaN sigma or
    op leaves alpha = 0.999."""
    col = lambda j: g[..., j][:, None, :]  # noqa: E731
    pxe, pye = px[:, :, None], py[:, :, None]
    tmpx, tmpy, tmpz = (col(2 + i) + col(5 + i) * pxe + col(8 + i) * pye for i in range(3))
    bad = tmpz.abs() < 1e-9
    rtz = 1.0 / torch.where(bad, torch.ones_like(tmpz), tmpz)
    s3d = torch.where(bad, torch.full_like(tmpz, SIGMA_BAD), (tmpx * tmpx + tmpy * tmpy) * (rtz * rtz))
    dx, dy = col(0) - pxe, col(1) - pye
    sigma = 0.5 * torch.fmin(s3d, 2.0 * (dx * dx + dy * dy))
    alpha = torch.fmin(torch.tensor(0.999), col(11) * torch.exp(-sigma))
    return (alpha >= torch.as_tensor(THRESHOLD)).any(1)


CASES = ["projected", "random", "edge_on", "tmpz_below_1e-9", "op_at_threshold",
         "far_larger_than_the_tile", "grazing"]


@pytest.mark.parametrize("tile_size", [16, 8])
@pytest.mark.parametrize("case", CASES)
def test_surfel_cull_never_drops_an_entry_that_reaches(case, tile_size):
    rng = np.random.default_rng(CASES.index(case) + 10 * tile_size)
    px, py, box = _warps(tile_size, rng, 48)
    g = _layout(case, rng, px, py, 128)
    reach, keep = _reach(g, px, py), may_reach(g, box)
    assert int(reach.sum()) > 0
    assert not bool((reach & ~keep).any()), (
        f"{int((reach & ~keep).sum())} of {int(reach.sum())} reaching entries dropped")
    if case == "grazing":  # the layout grazes: some reach, some are dropped
        assert float(reach.float().mean()) > 0.05 and float(keep.float().mean()) < 0.97


def test_surfel_cull_keeps_nan_rows():
    rng = np.random.default_rng(5)
    px, py, box = _warps(16, rng, 16)
    g = _layout("random", rng, px, py, 96)
    for col in range(12):
        bad = g.clone()
        bad[:, ::3, col] = float("nan")
        reach, keep = _walk_reach(bad, px, py), may_reach(bad, box)
        assert not bool((reach & ~keep).any()), col
        if col == 11:  # a NaN opacity: alpha 0.999 at every pixel
            assert bool(keep[:, ::3].all())
    whole = g.clone()
    whole[:, ::2] = float("nan")
    assert bool(may_reach(whole, box)[:, ::2].all())


@pytest.mark.parametrize("tile_size", [16, 8])
def test_surfel_cull_drops_surfels_clear_of_the_warp(tile_size):
    """Round surfels facing the camera whose footprint at alpha = 1/255
    (radius size·sqrt(2 log(255 op))) lies 1.5 radii or further from the
    warp's box: nearly all dropped. On the projected bench surfels the warp
    keeps well under all of its candidates."""
    rng = np.random.default_rng(20 + tile_size)
    px, py, box = _warps(tile_size, rng, 48)
    W, K = px.shape[0], 128
    op = rng.uniform(0.05, 0.95, (W, K))
    size = rng.uniform(0.8, 4.0, (W, K))
    radius = size * np.sqrt(2 * np.log(255 * op))
    ang = rng.uniform(0, 2 * np.pi, (W, K))
    cx, cy = px.mean(1).numpy()[:, None], py.mean(1).numpy()[:, None]
    half = np.array([tile_size, 32 // tile_size]) / 2
    # beyond the box's circumscribed circle by 1.5-4 radii
    dist = np.hypot(*half) + radius * rng.uniform(1.5, 4.0, (W, K))
    c = np.stack([cx + dist * np.cos(ang), cy + dist * np.sin(ang)], -1)
    g = _rows(c, _shapes(rng, W, K, size, iso=True), np.broadcast_to([0.0, 0.0, 1.0], (W, K, 3)),
              op)
    keep = may_reach(g, box)
    assert not bool(_reach(g, px, py).any())
    dropped = 1.0 - float(keep.float().mean())
    assert dropped >= 0.9, f"only {dropped:.3f} of the surfels clear of the warp dropped"
    g = _layout("projected", rng, px, py, K)
    reach, keep = _reach(g, px, py), may_reach(g, box)
    assert float(keep.float().mean()) < 0.8
    assert float(reach.float().mean()) < float(keep.float().mean())
