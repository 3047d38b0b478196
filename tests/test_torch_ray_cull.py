"""The bound with which kernel 7 culls eval3d entries per warp
(``tdgs_torch/csrc/ray_cull.cuh``), held on the CPU through a float32
PyTorch mirror written from the same derivation: in each entry's canonical
frame, the least distance |g × r| / |r| of the warp's rays from the
gaussian's centre over the box of their slopes about the warp's mean
direction, against sqrt(2 log(255 op)) with the header's margins.

On seeded warps of 32 rays from ``tile_rays_world`` (a 1920x1080 pinhole
camera with the bench scene's focal length, central and with a rolling
shutter) and gaussians at the bench scene's depths and scales placed about
each warp, it checks that the bound is sound -- it never drops an entry at
which the plain ``_response_eval3d`` gives alpha >= 1/255 at a ray of the
warp -- on the bench layout and on adversarial ones (entries grazing the
bound, op at 1/255, scales 1e-4 against 1, a camera inside the gaussian,
entries behind the camera, 8-pixel tiles), that NaN rows are kept, and
that it is not vacuous: it drops nearly every entry whose bounding sphere
(radius sqrt(2 log(255 op)) max(s)) lies clear of the warp's rays. The
kernel's own agreement is held on the card by
``tests/test_torch_kernel_card.py``: against the plain version on layouts
that graze the bound, and at full size.
"""

import math

import numpy as np
import pytest
import torch

from tdgs_torch.ops import rasterize_eval3d_packed as E
from tdgs_torch.ops.camera_models import RollingShutterType

EPS = 2.0 ** -24
THRESHOLD = np.float32(1.0 / 255.0)
WIDTH, HEIGHT, FOCAL = 1920, 1080, 1400.0


def _dot(x, y):
    return (x * y).sum(-1)


def _nan_max(x, dim):
    """max along ``dim`` that a NaN anywhere makes NaN, as warp_max."""
    return torch.where(torch.isnan(x).any(dim), torch.full_like(x.amax(dim), float("nan")),
                       x.amax(dim))


def warp_rays(d, o, inside, row):
    """ray_cull.cuh ``warp_rays`` over warps [W, 32] of rays d (and o' or
    None): the frame (a, b, n), the slope box (S, G), the mean apex offset
    o_c, its spread o_dev and whether the warp culls at all."""
    zero = torch.zeros((), dtype=torch.float32)
    s = torch.where(inside[..., None], d, zero).sum(1)
    a = s * torch.rsqrt(_dot(s, s))[:, None]
    e = d[:, row - 1] - d[:, 0]
    e = e - _dot(e, a)[:, None] * a
    b = e * torch.rsqrt(_dot(e, e))[:, None]
    n = torch.cross(a, b, dim=-1)
    al = _dot(d, a[:, None])
    ahead = al > 0
    big = torch.tensor(1e30, dtype=torch.float32)
    sb = torch.where(ahead, _dot(d, b[:, None]).abs() / al, big)
    sg = torch.where(ahead, _dot(d, n[:, None]).abs() / al, big)
    S = _nan_max(torch.where(inside, sb, zero), 1) * (1 + 1e-5) + 1e-6
    G = _nan_max(torch.where(inside, sg, zero), 1) * (1 + 1e-5) + 1e-6
    if o is None:
        oc = torch.zeros_like(a)
        odev = torch.zeros_like(S)
    else:
        n_in = inside.sum(1).to(torch.float32)
        oc = torch.where(inside[..., None], o, zero).sum(1) / n_in[:, None]
        dv = o - oc[:, None]
        odev = _nan_max(torch.where(inside, _dot(dv, dv).sqrt(), zero), 1)
        odev = odev * (1 + 1e-5) + 1e-6 * _dot(oc, oc).sqrt()
    ok = (S <= 1) & (G <= 1) & (odev < 1e30)
    return dict(a=a, b=b, n=n, S=S, G=G, oc=oc, odev=odev, ok=ok)


def _clamp(x, lim):
    return torch.minimum(torch.maximum(x, -lim), lim)


def may_reach(rows, w):
    """ray_cull.cuh ``may_reach`` of entries ``rows`` [W, K, 13 + D] against
    the warps' rays ``w`` → [W, K] bool: the least canonical distance
    |g × r| / |r| over the warp's slope box against sqrt(2 (log(255 op) +
    0.25)), with the header's margins."""
    m = rows[..., :9].reshape(rows.shape[:2] + (3, 3))  # rows of M
    op = rows[..., 12]
    mx = _dot(m, m).amax(-1)

    def times_m(v):  # M v for one vector per warp
        return (m * v[:, None, None]).sum(-1)

    g = rows[..., 9:12] + times_m(w["oc"])
    ra, rb, rn = times_m(w["a"]), times_m(w["b"]), times_m(w["n"])
    mnorm = (3 * mx).sqrt()
    gmag = _dot(g, g).sqrt() + mnorm * w["odev"][:, None]
    xa, xb, xn = (torch.cross(g, r, dim=-1) for r in (ra, rb, rn))
    xbn = torch.cross(xb, xn, dim=-1)
    A, B, C = _dot(xb, xb), _dot(xb, xn), _dot(xn, xn)
    P, Q = _dot(xa, xb), _dot(xa, xn)
    det = _dot(xbn, xbn)
    S, G = w["S"][:, None].expand_as(A), w["G"][:, None].expand_as(A)
    # the zero of x_a + s x_b + t x_n outside the box: the least norm lies
    # on an edge
    s0, t0 = (B * Q - C * P) / det, (B * P - A * Q) / det
    outside = (det > 0) & ((s0.abs() > S) | (t0.abs() > G))

    def h(s, t):
        v = xa + s[..., None] * xb + t[..., None] * xn
        return _dot(v, v)

    h_min = torch.minimum(
        torch.minimum(h(S, _clamp(-(Q + S * B) / C, G)), h(-S, _clamp(-(Q - S * B) / C, G))),
        torch.minimum(h(_clamp(-(P + G * B) / A, S), G), h(_clamp(-(P - G * B) / A, S), -G)))
    dr = 4e-6 * mnorm
    num = (h_min.sqrt() * (1 - 1e-5) - 1e-5 * (_dot(xa, xa).sqrt() + S * A.sqrt() + G * C.sqrt())
           - gmag * dr)
    den = (_dot(ra, ra).sqrt() + S * _dot(rb, rb).sqrt() + G * _dot(rn, rn).sqrt()) * (1 + 1e-5) + dr
    dist = num / den - mnorm * w["odev"][:, None] - 16 * EPS * gmag
    rho = torch.sqrt(2 * (torch.log(255 * op) + 0.25))
    drop = w["ok"][:, None] & (mx < 1e24) & (gmag < 1e25) & outside & (dist > rho)
    return torch.where(op < THRESHOLD, torch.zeros_like(drop), ~drop)


def _camera():
    viewmats = torch.eye(4)[None]
    Ks = torch.tensor([[[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]]])
    return viewmats, Ks


def _rays(tile_size, rolling_shutter):
    """Tile rays of the camera (1920x1080, the bench focal length): (d, o'
    or None, o_ref, inside) per tile pixel."""
    viewmats, Ks = _camera()
    tw, th = math.ceil(WIDTH / tile_size), math.ceil(HEIGHT / tile_size)
    kw = {}
    if rolling_shutter:
        end = viewmats.clone()
        ang = np.deg2rad(0.5)
        rot = torch.tensor([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                            [-np.sin(ang), 0, np.cos(ang)]], dtype=torch.float32)
        end[:, :3, :3] = rot @ end[:, :3, :3]
        end[:, 0, 3] += 0.02
        kw = dict(rolling_shutter=RollingShutterType.TOP_TO_BOTTOM, viewmats_rs=end)
    d, o, o_ref = E.tile_rays_world(1, tw, th, tile_size, WIDTH, HEIGHT, viewmats, Ks, **kw)
    P = tile_size * tile_size
    t = torch.arange(tw * th)
    p = torch.arange(P)
    px = (t % tw * tile_size)[:, None] + p % tile_size
    py = (t // tw * tile_size)[:, None] + p // tile_size
    return d, o, o_ref, (px < WIDTH) & (py < HEIGHT)


def _random_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _layout(name, rng, d_w, o_w, o_ref, n_entries):
    """Gaussians placed about each warp [W, 32] of rays: (means [W, K, 3],
    quats, scales, opacities [W, K])."""
    W = d_w.shape[0]
    K = n_entries
    lane = rng.integers(0, 32, size=(W, K))
    u = d_w[np.arange(W)[:, None], lane].numpy()  # a ray of the warp
    # a direction a few tens of pixels off that ray
    off = rng.uniform(-40, 40, size=(W, K, 2)) / FOCAL
    perp1 = np.cross(u, np.array([0.0, 1.0, 0.0]))
    perp1 /= np.linalg.norm(perp1, axis=-1, keepdims=True)
    perp2 = np.cross(u, perp1)
    dirs = u + off[..., :1] * perp1 + off[..., 1:] * perp2
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    depth = rng.uniform(3.0, 14.0, size=(W, K, 1))
    scales = rng.uniform(0.005, 0.03, size=(W, K, 3))
    opac = rng.uniform(0.3, 1.0, size=(W, K))
    quats = _random_quats(rng, W * K).reshape(W, K, 4)
    if name == "op_at_threshold":
        opac[:, ::2] = THRESHOLD
        opac[:, 1::4] = np.nextafter(THRESHOLD, np.float32(1))
    elif name == "anisotropic":
        # scales 1e-4 against 1: needles and discs
        scales = np.where(rng.random(size=(W, K, 3)) < 0.5, 1e-4, 1.0)
        scales[..., 0] = 1e-4
        depth = rng.uniform(3.0, 40.0, size=(W, K, 1))
    elif name == "grazing":
        # spheres (isotropic scales) sized so that their surface at
        # alpha = 1/255 lies within 10% of the warp's nearest ray
        means = o_ref + depth * dirs
        apex = np.zeros_like(d_w.numpy()) if o_w is None else o_w.numpy()
        v = means[:, None] - o_ref - apex[:, :, None]  # [W, 32, K, 3]
        u_w = d_w.numpy() / np.linalg.norm(d_w.numpy(), axis=-1, keepdims=True)
        near = np.linalg.norm(np.cross(v, u_w[:, :, None]), axis=-1).min(1)  # [W, K]
        s = near * rng.uniform(0.9, 1.1, (W, K)) / np.sqrt(2 * np.log(255 * opac))
        return means, quats, np.repeat(s[..., None], 3, axis=-1), opac
    elif name == "camera_inside":
        depth = rng.uniform(0.0, 0.5, size=(W, K, 1))
        scales = rng.uniform(0.3, 1.0, size=(W, K, 3))
    elif name == "behind_camera":
        depth = np.concatenate([depth[:, : K // 2], -depth[:, K // 2:]], axis=1)
    means = o_ref + depth * dirs
    return means, quats, scales, opac


def _warps(tile_size, rolling_shutter, rng, n_warps):
    d, o, o_ref, inside = _rays(tile_size, rolling_shutter)
    T, P, _ = d.shape
    tiles = torch.as_tensor(rng.choice(T, size=n_warps, replace=False))
    warp = torch.as_tensor(rng.integers(0, P // 32, size=n_warps))
    lanes = warp[:, None] * 32 + torch.arange(32)
    pick = (tiles[:, None], lanes)
    return (d[pick].contiguous(), None if o is None else o[pick].contiguous(), o_ref,
            inside[pick])


def _case(name, tile_size=16, rolling_shutter=False, n_warps=48, n_entries=192, seed=0):
    """(rows [W, K, 13 + 3], d_w, o_w, inside, reaches [W, K]): whether
    each entry reaches alpha >= 1/255 at a ray of its warp by the plain
    version of kernel 7's response."""
    rng = np.random.default_rng(seed)
    d_w, o_w, o_ref, inside = _warps(tile_size, rolling_shutter, rng, n_warps)
    means, quats, scales, opac = _layout(name, rng, d_w, o_w, o_ref[0].numpy(), n_entries)
    W, K = opac.shape
    t32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32))  # noqa: E731
    rows = E.feature_rows(t32(means.reshape(-1, 3)), t32(quats.reshape(-1, 4)),
                          t32(scales.reshape(-1, 3)), t32(opac.reshape(1, -1)),
                          torch.zeros((1, W * K, 3)), o_ref)
    # the plain response of each warp's rays against its own entries
    idx = torch.arange(W * K).reshape(W, K)
    sigma, op = E._response_eval3d(rows, d_w, o_w)(torch.arange(W), idx, None, None, None)[:2]
    alpha = torch.clamp(op * torch.exp(-sigma), max=0.999)
    reach = (sigma >= 0) & (alpha >= torch.as_tensor(THRESHOLD)) & inside[:, :, None]
    return rows.reshape(W, K, -1), d_w, o_w, inside, reach.any(1)


CASES = {
    "bench": {},
    "bench_rolling_shutter": dict(rolling_shutter=True),
    "bench_tile_8": dict(tile_size=8),
    "grazing": {},
    "grazing_rolling_shutter": dict(rolling_shutter=True),
    "op_at_threshold": {},
    "anisotropic": {},
    "anisotropic_rolling_shutter": dict(rolling_shutter=True),
    "camera_inside": {},
    "behind_camera": {},
}


@pytest.mark.parametrize("case", list(CASES))
def test_ray_cull_never_drops_an_entry_that_reaches(case):
    kw = CASES[case]
    layout = case.replace("_rolling_shutter", "").replace("_tile_8", "")
    rows, d_w, o_w, inside, reach = _case(layout, **kw, seed=len(case))
    keep = may_reach(rows, warp_rays(d_w, o_w, inside, min(kw.get("tile_size", 16), 32)))
    assert int(reach.sum()) > 0
    assert not bool((reach & ~keep).any()), (
        f"{int((reach & ~keep).sum())} of {int(reach.sum())} reaching entries dropped")


def _clear_of_rays(rows, d_w, o_w, inside, margin):
    """Entries whose sphere (radius sqrt(2 log(255 op)) max(s)) lies
    ``margin`` times its radius or further from every ray of the warp, in
    float64."""
    r = rows.double()
    m = r[..., :9].reshape(r.shape[:2] + (3, 3))
    nr = _dot(m, m)
    mu = -(r[..., 9:12, None] / nr[..., :, None] * m).sum(-2)  # mu - o_ref
    radius = torch.sqrt(2 * torch.log(255 * r[..., 12])) / nr.amin(-1).sqrt()
    d = d_w.double() / d_w.double().norm(dim=-1, keepdim=True)  # [W, 32, 3]
    apex = torch.zeros_like(d) if o_w is None else o_w.double()
    v = mu[:, None] - apex[:, :, None]  # [W, 32, K, 3]
    dist = torch.cross(v, d[:, :, None].expand_as(v), dim=-1).norm(dim=-1)
    dist = torch.where(inside[:, :, None], dist, torch.full_like(dist, float("inf")))
    return dist.amin(1) > margin * radius


@pytest.mark.parametrize("case", ["bench", "bench_rolling_shutter", "bench_tile_8"])
def test_ray_cull_drops_entries_clear_of_the_warp(case):
    kw = CASES[case]
    rows, d_w, o_w, inside, reach = _case("bench", **kw, seed=100 + len(case))
    keep = may_reach(rows, warp_rays(d_w, o_w, inside, min(kw.get("tile_size", 16), 32)))
    clear = _clear_of_rays(rows, d_w, o_w, inside, 1.2)
    assert int(clear.sum()) > 1000
    assert not bool((clear & reach).any())
    dropped = float((clear & ~keep).sum()) / float(clear.sum())
    assert dropped >= 0.9, f"only {dropped:.3f} of the entries clear of the warp dropped"
    # and the warp keeps few of the entries that reach none of its rays
    assert float(keep.float().mean()) < 0.8


def test_ray_cull_keeps_nan_rows_and_warps():
    rows, d_w, o_w, inside, _ = _case("bench", n_warps=8, n_entries=64)
    w = warp_rays(d_w, o_w, inside, 16)
    for col in (0, 4, 8, 10, 12):
        bad = rows.clone()
        bad[:, ::3, col] = float("nan")
        assert bool(may_reach(bad, w)[:, ::3].all()), col
    # a NaN ray keeps every entry of its warp
    d_bad = d_w.clone()
    d_bad[:, 5, 1] = float("nan")
    assert bool(may_reach(rows, warp_rays(d_bad, o_w, inside, 16))[rows[..., 12] >= THRESHOLD]
                .all())
