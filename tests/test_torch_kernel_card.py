"""The CUDA kernels against their plain PyTorch versions, on the card: the
compositing forward (kernel 1), its backward (kernel 2), the sorted
segment sum (kernel 3), the 2DGS forwards (kernels 4 and 5) and
backward (kernel 6), the eval3d (3DGUT) forward (kernel 7) and
backward (kernel 8), and the tile-dense forward (kernel 9) and backward
(kernel 10).

The kernels have no CPU mode, so every test here is marked ``cuda`` and skips
without a card. The file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_card.py

Tolerances, as chip_smoke.py holds the kernels at full size: 1e-3 absolute
for the forward (the kernel accumulates colours in a running sum, the plain
version in a matrix product); max|Δ| / max|plain| ≤ 1e-3 per gradient group
for the backward (the kernel sums 256 pixels by shuffles, the plain version
with ``sum``); 1e-5 relative per column for the segment sum, whose two
launches must agree bit for bit. The 2DGS kernels are held as kernels 1
and 2 are, with the distortion and the gradient groups relative to their
scale and median depth, a selected entry, allowed to differ in 1% of the
pixels (the plain version's cumprod on the card rounds its running
product differently at the 1e-4 cutoff). The eval3d kernels are held as
kernels 1 and 2 are, the ray gradients per group like the rows; the
tile-dense kernels as kernels 1 and 2 are.
"""

import numpy as np
import pytest
import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops import segment_sum as S
from tdgs_torch.ops.rasterize_packed import (
    KERNEL,
    KERNEL_BWD,
    rasterize_packed_bwd,
    rasterize_packed_bwd_plain,
    rasterize_packed_train_fwd,
    rasterize_packed_train_fwd_plain,
    rasterize_to_pixels_packed,
    rasterize_to_pixels_packed_inference,
    rasterize_to_pixels_packed_inference_plain,
)
from tdgs_torch.ops.tiling import isect_tiles_packed

ATOL = 1e-3
W, H = 40, 36  # a partial last tile row and column


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _stream(seed, D, N=300, min_radius=10):
    """Random screen-space gaussians, tiled by the port on the CPU."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(0, [W, H], size=(1, N, 2)).astype(np.float32)
    A = rng.normal(size=(1, N, 2, 2)).astype(np.float32)
    cov = A @ np.swapaxes(A, -1, -2) + 2.0 * np.eye(2, dtype=np.float32)
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]], -1)
    radii = np.maximum(np.ceil(3.33 * np.sqrt(np.stack(
        [cov[..., 0, 0], cov[..., 1, 1]], -1))), min_radius).astype(np.int32)
    depths = rng.uniform(0.1, 10, size=(1, N)).astype(np.float32)
    isect = isect_tiles_packed(torch.from_numpy(means2d), torch.from_numpy(radii),
                               torch.from_numpy(depths), 16, 3, 3,
                               max_tiles_per_gauss=16)
    return dict(
        means2d=torch.from_numpy(means2d),
        conics=torch.from_numpy(conics.astype(np.float32)),
        colors=torch.from_numpy(rng.uniform(0, 1, size=(1, N, D)).astype(np.float32)),
        opacities=torch.from_numpy(rng.uniform(0.05, 0.95, size=(1, N)).astype(np.float32)),
        offsets=isect.offsets, flatten_ids=isect.flatten_ids,
    )


def _args(s, device):
    t = {k: v.to(device) for k, v in s.items()}
    return (t["means2d"], t["conics"], t["colors"], t["opacities"], W, H, 16,
            t["offsets"], t["flatten_ids"])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 3, 4, 8, 16, 32])  # every templated width
@pytest.mark.parametrize("tile_capacity", [128, 1024])  # with and without cuts
def test_kernel_matches_plain_on_card(cuda_device, D, tile_capacity):
    args = _args(_stream(119 + D, D), cuda_device)
    bg = torch.linspace(0.1, 0.9, D, device=cuda_device)[None]
    before = _build.LAUNCHES.get(KERNEL, 0)
    got = rasterize_to_pixels_packed_inference(*args, backgrounds=bg,
                                               tile_capacity=tile_capacity)
    assert _build.LAUNCHES[KERNEL] == before + 1
    want = rasterize_to_pixels_packed_inference_plain(*args, backgrounds=bg,
                                                      tile_capacity=tile_capacity)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    assert float(want[1].max()) > 0.5  # the scene covers pixels


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    args = list(_args(_stream(120, 3, N=20), cuda_device))
    with pytest.raises(TypeError):  # int64 offsets
        rasterize_to_pixels_packed_inference(*args[:7], args[7].long(), args[8])
    with pytest.raises(ValueError):  # non-contiguous conics
        bad = args[1].transpose(-1, -2).contiguous().transpose(-1, -2)
        rasterize_to_pixels_packed_inference(args[0], bad, *args[2:])
    with pytest.raises(ValueError):  # more channels than the kernel takes
        wide = torch.zeros(args[2].shape[:-1] + (33,), device=cuda_device)
        rasterize_to_pixels_packed_inference(args[0], args[1], wide, *args[3:])
    with pytest.raises(ValueError):  # operands on two devices
        rasterize_to_pixels_packed_inference(args[0], args[1].cpu(), *args[2:])


# groups of a gradient row: means2d, conics, opacity, colours
GROUPS = {"means2d": slice(0, 2), "conics": slice(2, 5), "opacities": slice(5, 6),
          "colors": slice(6, None)}


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 4, 16, 32])
@pytest.mark.parametrize("tile_capacity", [128, 1024])
def test_bwd_kernel_matches_plain_on_card(cuda_device, D, tile_capacity):
    s = _stream(131 + D, D)
    args = _args(s, cuda_device)
    rng = np.random.default_rng(D)
    before = _build.LAUNCHES.get(KERNEL, 0)
    img, trans = rasterize_packed_train_fwd(*args, tile_capacity=tile_capacity)
    assert _build.LAUNCHES[KERNEL] == before + 1
    img_p, trans_p = rasterize_packed_train_fwd_plain(*args, tile_capacity=tile_capacity)
    torch.testing.assert_close(img, img_p, rtol=0, atol=ATOL)
    torch.testing.assert_close(trans, trans_p, rtol=0, atol=ATOL)
    v_img = torch.from_numpy(rng.normal(size=tuple(img.shape)).astype(np.float32)).to(cuda_device)
    v_t = torch.from_numpy(rng.normal(size=tuple(trans.shape)).astype(np.float32)).to(cuda_device)
    before = _build.LAUNCHES.get(KERNEL_BWD, 0)
    got = rasterize_packed_bwd(*args, img, trans, v_img, v_t, tile_capacity=tile_capacity)
    assert _build.LAUNCHES[KERNEL_BWD] == before + 1
    want = rasterize_packed_bwd_plain(*args, img, trans, v_img, v_t,
                                      tile_capacity=tile_capacity)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (s["flatten_ids"].shape[0], 6 + D)
    assert bool(torch.isfinite(got).all())
    for name, cols in GROUPS.items():
        err = _rel_err(got[:, cols], want[:, cols])
        assert err <= 1e-3, (name, err)
    n = int(s["offsets"][-1])
    assert got.shape[0] > n  # the capped stream has padding slots
    assert float(got[n:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("F,abs_cols", [(9, True), (10, False), (38, True), (64, False)])
def test_segment_sum_kernel_matches_plain_on_card(cuda_device, F, abs_cols):
    rng = np.random.default_rng(F)
    E, n = 20_000, 3_000
    ids = rng.integers(0, n, size=E).astype(np.int32)
    ids[:4000] = 17  # one giant segment
    rows = torch.from_numpy(rng.normal(size=(E, F)).astype(np.float32)).to(cuda_device)
    sids, perm = S.sort_ids(torch.from_numpy(ids).to(cuda_device),
                            torch.tensor(E - 100, device=cuda_device))
    before = _build.LAUNCHES.get(S.KERNEL, 0)
    a = S.segment_rows_sum(rows, perm, sids, n, abs_cols=abs_cols)
    b = S.segment_rows_sum(rows, perm, sids, n, abs_cols=abs_cols)
    assert _build.LAUNCHES[S.KERNEL] == before + 2
    want = S.segment_rows_sum_plain(rows, perm, sids, n, abs_cols=abs_cols)
    torch.cuda.synchronize()
    assert torch.equal(a, b)  # deterministic, bit for bit
    for col in range(a.shape[1]):  # each column against its own scale
        assert _rel_err(a[:, col], want[:, col]) <= 1e-5, col


def _two_image_stream(seed, D=3, N=200):
    """Two images of one batch, tiled together by the port on the CPU."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(0, [W, H], size=(2, N, 2)).astype(np.float32)
    conics = np.tile(np.array([0.02, 0.004, 0.03], np.float32), (2, N, 1))
    radii = np.full((2, N, 2), 12, np.int32)
    depths = rng.uniform(0.1, 10, size=(2, N)).astype(np.float32)
    isect = isect_tiles_packed(torch.from_numpy(means2d), torch.from_numpy(radii),
                               torch.from_numpy(depths), 16, 3, 3, max_tiles_per_gauss=16)
    return dict(
        means2d=torch.from_numpy(means2d), conics=torch.from_numpy(conics),
        colors=torch.from_numpy(rng.uniform(0, 1, size=(2, N, D)).astype(np.float32)),
        opacities=torch.from_numpy(rng.uniform(0.05, 0.95, size=(2, N)).astype(np.float32)),
        offsets=isect.offsets, flatten_ids=isect.flatten_ids,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("n_images", [1, 2])
def test_packed_autograd_on_card_matches_cpu(cuda_device, n_images):
    """The whole differentiable rasterizer: kernels 1-3 on the card against
    the plain versions on the CPU, with a background and the AbsGS tap."""
    s = _stream(140, 3) if n_images == 1 else _two_image_stream(141)
    rng = np.random.default_rng(140)
    grads = {}
    for dev in ("cpu", cuda_device):
        t = {k: v.to(dev) for k, v in s.items()}
        leaves = [t[k].clone().requires_grad_(True)
                  for k in ("means2d", "conics", "colors", "opacities")]
        dummy = torch.zeros((n_images * leaves[0].shape[1], 2), device=dev,
                            requires_grad=True)
        img, alp = rasterize_to_pixels_packed(
            *leaves, W, H, 16, t["offsets"], t["flatten_ids"],
            backgrounds=torch.tensor([[0.2, 0.5, 0.8]] * n_images, device=dev),
            absgrad_dummy=dummy)
        wi = torch.from_numpy(rng.normal(size=tuple(img.shape)).astype(np.float32)).to(dev)
        wa = torch.from_numpy(rng.normal(size=tuple(alp.shape)).astype(np.float32)).to(dev)
        ((img * wi).sum() + (alp * wa).sum()).backward()
        grads[str(dev)] = [x.grad.cpu() for x in leaves + [dummy]]
        rng = np.random.default_rng(140)
    for g, w in zip(grads[str(cuda_device)], grads["cpu"]):
        assert _rel_err(g, w) <= 1e-3


# ---------------------------------------------------------------------------
# 2DGS: kernels 4 (inference forward), 5 (training forward) and 6 (backward)
# ---------------------------------------------------------------------------


def _surfel_stream(seed, D, n_images=1, N=300):
    """Random surfels projected and tiled by the port on the CPU; every
    third one below a pixel (the σ2d branch). The last colour channel is
    the depth, as render_mode "RGB+ED" gives the rasterizer."""
    from tdgs_torch.ops.projection_2dgs import fully_fused_projection_2dgs
    from tdgs_torch.ops.rasterize_2dgs_packed import feature_rows

    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(N, 3)) * [1.0, 0.8, 0.5] + [0, 0, 5]).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 0.4, size=(N, 3)).astype(np.float32)
    scales[::3] *= 0.08
    viewmats = np.tile(np.eye(4, dtype=np.float32), (n_images, 1, 1))
    viewmats[1:, :3, 3] = [0.3, -0.2, 0.1]
    Ks = np.tile(np.array([[40.0, 0, W / 2], [0, 40, H / 2], [0, 0, 1]], np.float32),
                 (n_images, 1, 1))
    radii, means2d, depths, M, normals = fully_fused_projection_2dgs(
        *map(torch.from_numpy, (means, quats, scales, viewmats, Ks)), W, H)
    isect = isect_tiles_packed(means2d, radii, depths, 16, 3, 3, max_tiles_per_gauss=16)
    colors = torch.from_numpy(rng.uniform(0, 1, size=(n_images, N, D)).astype(np.float32))
    colors[..., -1] = depths
    opac = torch.from_numpy(rng.uniform(0.05, 0.95, size=(n_images, N)).astype(np.float32))
    feats = feature_rows(means2d, M, colors, normals, opac)
    return dict(rows=feats[isect.flatten_ids.long()].contiguous(), offsets=isect.offsets,
                means2d=means2d, ray_transforms=M, colors=colors, normals=normals,
                opacities=opac, flatten_ids=isect.flatten_ids)


def _median_share(got, want):
    return float(((got - want).abs() > 1e-5).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4, 8, 32])  # every templated channel bound
@pytest.mark.parametrize("tile_capacity", [128, 1024])
@pytest.mark.parametrize("n_images", [1, 2])
def test_2dgs_kernels_match_plain_on_card(cuda_device, D, tile_capacity, n_images):
    from tdgs_torch.ops import rasterize_2dgs_packed as R

    s = _surfel_stream(150 + D, D, n_images)
    rows, offs = s["rows"].to(cuda_device), s["offsets"].to(cuda_device)
    I, tc = n_images, tile_capacity
    geo = (rows, offs, I, D, W, H, 16)
    bg = torch.linspace(0.1, 0.9, D, device=cuda_device).repeat(I, 1)

    before = {k: _build.LAUNCHES.get(k, 0) for k in (R.KERNEL_FWD, R.KERNEL_TRAIN, R.KERNEL_BWD)}
    got = R.rasterize_2dgs_inference(*geo, bg, tc)
    p_img, p_nrm, p_T, p_dist, p_med, _ = R.rasterize_2dgs_fwd_plain(
        *geo, tc, depth_row=D - 1, compute_distort=True)
    want = (p_img + p_T[..., None] * bg[:, None, None, :], (1.0 - p_T)[..., None], p_nrm)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    assert float(want[1].max()) > 0.5  # the surfels cover pixels

    img, nrm, T, dist, med = R.rasterize_2dgs_train_fwd(*geo, tc, D - 1, True)
    for g, w in ((img, p_img), (nrm, p_nrm), (T, p_T)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    assert _rel_err(dist, p_dist) <= 1e-3 and float(p_dist.abs().max()) > 0
    assert _median_share(med, p_med) <= 0.01

    rng = np.random.default_rng(D + 7 * n_images)
    cot = [torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(cuda_device)
           for x in (img, nrm, T, dist)]
    v_rows = R.rasterize_2dgs_bwd(*geo, img, nrm, T, dist, *cot, tc, D - 1, True)
    want_rows = R.rasterize_2dgs_bwd_plain(*geo, img, nrm, T, dist, *cot, tc, D - 1, True)
    torch.cuda.synchronize()
    after = {k: _build.LAUNCHES.get(k, 0) for k in before}
    assert all(after[k] == before[k] + 1 for k in before)
    assert v_rows.shape == want_rows.shape == (rows.shape[0], 12 + D + 3)
    assert bool(torch.isfinite(v_rows).all())
    groups = {"means2d": slice(0, 2), "t0_tpx_tpy": slice(2, 11), "opacity": slice(11, 12),
              "channels": slice(12, None)}
    for name, cols in groups.items():
        assert _rel_err(v_rows[:, cols], want_rows[:, cols]) <= 1e-3, name
    n = int(s["offsets"][-1])
    assert float(v_rows[n:].abs().sum()) == 0.0  # the stream's padding


@pytest.mark.cuda
def test_2dgs_wrappers_reject_bad_inputs(cuda_device):
    from tdgs_torch.ops import rasterize_2dgs_packed as R

    s = _surfel_stream(160, 4, N=30)
    rows, offs = s["rows"].to(cuda_device), s["offsets"].to(cuda_device)
    with pytest.raises(TypeError):  # int64 offsets
        R.rasterize_2dgs_inference(rows, offs.long(), 1, 4, W, H, 16)
    with pytest.raises(ValueError):  # rows of the wrong width for D
        R.rasterize_2dgs_train_fwd(rows, offs, 1, 5, W, H, 16)
    with pytest.raises(ValueError):  # operands on two devices
        R.rasterize_2dgs_inference(rows, offs.cpu(), 1, 4, W, H, 16)
    with pytest.raises(ValueError):  # a depth row outside the channels
        R.rasterize_2dgs_train_fwd(rows, offs, 1, 4, W, H, 16, depth_row=4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_images", [1, 2])
def test_2dgs_autograd_on_card_matches_cpu(cuda_device, n_images):
    """The whole differentiable 2DGS rasterizer: kernels 5, 6 and the
    segment sum on the card against the plain versions on the CPU, with a
    background, distortion and the AbsGS tap."""
    from tdgs_torch.ops.rasterize_2dgs_packed import rasterize_to_pixels_2dgs_packed

    s = _surfel_stream(170, 4, n_images)
    names = ("means2d", "ray_transforms", "colors", "normals", "opacities")
    grads = {}
    for dev in ("cpu", cuda_device):
        rng = np.random.default_rng(170)
        leaves = [s[k].to(dev).clone().requires_grad_(True) for k in names]
        dummy = torch.zeros((n_images * s["colors"].shape[1], 2), device=dev,
                            requires_grad=True)
        outs = rasterize_to_pixels_2dgs_packed(
            *leaves, W, H, 16, s["offsets"].to(dev), s["flatten_ids"].to(dev),
            backgrounds=torch.tensor([[0.2, 0.5, 0.8, 0.0]] * n_images, device=dev),
            has_depth=True, compute_distort=True, absgrad_dummy=dummy)
        loss = sum((o * torch.from_numpy(rng.normal(size=tuple(o.shape)).astype(np.float32))
                    .to(dev)).sum() for o in outs[:4])
        loss.backward()
        grads[str(dev)] = [x.grad.cpu() for x in leaves + [dummy]]
    for name, g, w in zip(names + ("abs",), grads[str(cuda_device)], grads["cpu"]):
        assert _rel_err(g, w) <= 1e-3, name


def _eval3d_stream(seed, D, n_images=1, rolling_shutter=False, N=300):
    """Random gaussians tiled by the port's projection on the CPU, with the
    eval3d rows and rays; a TOP_TO_BOTTOM shutter whose end pose has moved
    when ``rolling_shutter``."""
    from tdgs_torch.ops import rasterize_eval3d_packed as E
    from tdgs_torch.ops.camera_models import RollingShutterType
    from tdgs_torch.ops.projection import fully_fused_projection

    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(N, 3)) * [1.0, 0.8, 0.5] + [0, 0, 5]).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, size=(N, 3)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (n_images, 1, 1))
    viewmats[1:, :3, 3] = [0.3, -0.2, 0.1]
    Ks = np.tile(np.array([[40.0, 0, W / 2], [0, 40, H / 2], [0, 0, 1]], np.float32),
                 (n_images, 1, 1))
    t = {k: torch.from_numpy(v) for k, v in
         dict(means=means, quats=quats, scales=scales, viewmats=viewmats, Ks=Ks).items()}
    radii, means2d, depths, _, _ = fully_fused_projection(
        t["means"], t["quats"], t["scales"], t["viewmats"], t["Ks"], W, H)
    isect = isect_tiles_packed(means2d, radii, depths, 16, 3, 3, max_tiles_per_gauss=16)
    rs = {}
    if rolling_shutter:
        end = t["viewmats"].clone()
        end[:, 0, 3] += 0.15
        rs = dict(rolling_shutter=RollingShutterType.TOP_TO_BOTTOM, viewmats_rs=end)
    d, o, o_ref = E.tile_rays_world(n_images, 3, 3, 16, W, H, t["viewmats"], t["Ks"], **rs)
    t["colors"] = torch.from_numpy(rng.uniform(0, 1, size=(n_images, N, D)).astype(np.float32))
    t["opacities"] = torch.from_numpy(
        rng.uniform(0.05, 0.95, size=(n_images, N)).astype(np.float32))
    feats = E.feature_rows(t["means"], t["quats"], t["scales"], t["opacities"], t["colors"],
                           o_ref)
    return dict(t, rows=feats[isect.flatten_ids.long()].contiguous(), d=d.contiguous(),
                o=None if o is None else o.contiguous(), offsets=isect.offsets,
                flatten_ids=isect.flatten_ids, rs=rs)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 3, 8, 32])  # every templated channel bound
@pytest.mark.parametrize("tile_capacity", [128, 1024])
@pytest.mark.parametrize("rolling_shutter", [False, True])
def test_eval3d_kernels_match_plain_on_card(cuda_device, D, tile_capacity, rolling_shutter):
    from tdgs_torch.ops import rasterize_eval3d_packed as E

    n_images = 2 if rolling_shutter else 1
    s = _eval3d_stream(180 + D, D, n_images, rolling_shutter)
    dev = cuda_device
    o = None if s["o"] is None else s["o"].to(dev)
    geo = (s["rows"].to(dev), s["d"].to(dev), o, s["offsets"].to(dev), n_images, D, W, H, 16)
    tc = tile_capacity
    bg = torch.linspace(0.1, 0.9, D, device=dev).repeat(n_images, 1)

    before = {k: _build.LAUNCHES.get(k, 0) for k in (E.KERNEL_FWD, E.KERNEL_BWD)}
    img, alp = E.rasterize_eval3d_inference(*geo, bg, tc)
    p_img, p_T, _ = E.rasterize_eval3d_fwd_plain(*geo, tc)
    torch.cuda.synchronize()
    torch.testing.assert_close(img, p_img + p_T[..., None] * bg[:, None, None, :],
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(alp[..., 0], 1.0 - p_T, rtol=0, atol=ATOL)
    assert float(alp.max()) > 0.5  # the gaussians cover pixels

    img, T = E.rasterize_eval3d_train_fwd(*geo, tc)
    torch.testing.assert_close(img, p_img, rtol=0, atol=ATOL)
    torch.testing.assert_close(T, p_T, rtol=0, atol=ATOL)
    rng = np.random.default_rng(D + 7 * n_images)
    v_img, v_T = (torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(dev)
                  for x in (img, T))
    got = E.rasterize_eval3d_bwd(*geo, img, T, v_img, v_T, tc)
    want = E.rasterize_eval3d_bwd_plain(*geo, img, T, v_img, v_T, tc)
    torch.cuda.synchronize()
    after = {k: _build.LAUNCHES.get(k, 0) for k in before}
    assert after[E.KERNEL_FWD] == before[E.KERNEL_FWD] + 2
    assert after[E.KERNEL_BWD] == before[E.KERNEL_BWD] + 1
    assert got[0].shape == want[0].shape == (geo[0].shape[0], 13 + D)
    groups = {"M": slice(0, 9), "g0": slice(9, 12), "opacity": slice(12, 13),
              "colors": slice(13, None)}
    for name, cols in groups.items():
        assert _rel_err(got[0][:, cols], want[0][:, cols]) <= 1e-3, name
    assert _rel_err(got[1], want[1]) <= 1e-3, "v_d"
    if rolling_shutter:
        assert _rel_err(got[2], want[2]) <= 1e-3, "v_o"
    else:
        assert got[2] is None
    n = int(s["offsets"][-1])
    assert float(got[0][n:].abs().sum()) == 0.0  # the stream's padding


@pytest.mark.cuda
def test_eval3d_wrappers_reject_bad_inputs(cuda_device):
    from tdgs_torch.ops import rasterize_eval3d_packed as E

    s = _eval3d_stream(190, 3, N=30)
    rows, d, offs = (s[k].to(cuda_device) for k in ("rows", "d", "offsets"))
    with pytest.raises(TypeError):  # int64 offsets
        E.rasterize_eval3d_inference(rows, d, None, offs.long(), 1, 3, W, H, 16)
    with pytest.raises(ValueError):  # rows of the wrong width for D
        E.rasterize_eval3d_train_fwd(rows, d, None, offs, 1, 4, W, H, 16)
    with pytest.raises(ValueError):  # operands on two devices
        E.rasterize_eval3d_inference(rows, d.cpu(), None, offs, 1, 3, W, H, 16)
    with pytest.raises(ValueError):  # rays of the wrong shape
        E.rasterize_eval3d_train_fwd(rows, d[:, :100], None, offs, 1, 3, W, H, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("rolling_shutter", [False, True])
def test_eval3d_autograd_on_card_matches_cpu(cuda_device, rolling_shutter):
    """The whole differentiable eval3d rasterizer: kernels 7, 8 and the
    segment sum on the card against the plain versions on the CPU, with a
    background; gradients to the gaussians and to both poses."""
    from tdgs_torch.ops.rasterize_eval3d_packed import rasterize_to_pixels_eval3d_packed

    s = _eval3d_stream(195, 3, 2, rolling_shutter)
    names = ["means", "quats", "scales", "colors", "opacities", "viewmats"]
    grads = {}
    for dev in ("cpu", cuda_device):
        rng = np.random.default_rng(195)
        leaves = [s[k].to(dev).clone().requires_grad_(True) for k in names]
        rs = {}
        if rolling_shutter:
            rs = dict(s["rs"], viewmats_rs=s["rs"]["viewmats_rs"].to(dev).requires_grad_(True))
        img, alp = rasterize_to_pixels_eval3d_packed(
            *leaves, s["Ks"].to(dev), W, H, 16, s["offsets"].to(dev),
            s["flatten_ids"].to(dev), backgrounds=torch.tensor([[0.2, 0.5, 0.8]] * 2,
                                                               device=dev), **rs)
        loss = sum((x * torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32))
                    .to(dev)).sum() for x in (img, alp))
        inputs = leaves + ([rs["viewmats_rs"]] if rolling_shutter else [])
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(loss, inputs)]
    for name, g, w in zip(names + ["viewmats_rs"], grads[str(cuda_device)], grads["cpu"]):
        assert _rel_err(g, w) <= 1e-3, name


def _dense_stream(seed, D, n_images=1, N=300, tile_capacity=128):
    """Random screen-space gaussians through the dense tiling and the
    per-tile gather, on the CPU: (rows [T, cap, 6 + D], counts, inputs)."""
    from tdgs_torch.ops.rasterize_pallas import dense_rows
    from tdgs_torch.ops.tiling import isect_offset_encode, isect_tiles

    rng = np.random.default_rng(seed)
    I = n_images
    means2d = rng.uniform(0, [W, H], size=(I, N, 2)).astype(np.float32)
    A = rng.normal(size=(I, N, 2, 2)).astype(np.float32)
    cov = A @ np.swapaxes(A, -1, -2) + 2.0 * np.eye(2, dtype=np.float32)
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]], -1).astype(np.float32)
    radii = np.maximum(np.ceil(3.33 * np.sqrt(np.stack(
        [cov[..., 0, 0], cov[..., 1, 1]], -1))), 10).astype(np.int32)
    depths = rng.uniform(0.1, 10, size=(I, N)).astype(np.float32)
    isect = isect_tiles(torch.from_numpy(means2d), torch.from_numpy(radii),
                        torch.from_numpy(depths), 16, 3, 3, capacity=I * N * 9,
                        max_tiles_per_gauss=16)
    offsets = isect_offset_encode(isect.isect_keys, I, 3, 3)
    inputs = [torch.from_numpy(x) for x in (
        means2d, conics, rng.uniform(0, 1, size=(I, N, D)).astype(np.float32),
        rng.uniform(0.05, 0.95, size=(I, N)).astype(np.float32))]
    rows, counts = dense_rows(*inputs, offsets, isect.flatten_ids, isect.n_isects,
                              tile_capacity)
    return rows.detach(), counts, inputs, offsets, isect


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 4, 16])
@pytest.mark.parametrize("tile_capacity", [128, 1024])  # with and without cuts
@pytest.mark.parametrize("n_images", [1, 2])
def test_dense_kernels_match_plain_on_card(cuda_device, D, tile_capacity, n_images):
    from tdgs_torch.ops import rasterize_pallas as RP

    rows, counts, _, offsets, isect = _dense_stream(200 + D, D, n_images,
                                                    tile_capacity=tile_capacity)
    ends = torch.cat([offsets.reshape(-1)[1:].long(), torch.tensor([isect.n_isects])])
    cut = bool((ends - offsets.reshape(-1).long() > tile_capacity).any())
    assert cut == (tile_capacity == 128)  # the small capacity cuts tiles
    rows_c, counts_c = rows.to(cuda_device), counts.to(cuda_device)
    geo = (n_images, W, H, 16)
    before = _build.LAUNCHES.get(RP.KERNEL_FWD, 0)
    img, trans = RP.rasterize_dense_fwd(rows_c, counts_c, *geo)
    assert _build.LAUNCHES[RP.KERNEL_FWD] == before + 1
    img_p, trans_p = RP.rasterize_dense_fwd_plain(rows_c, counts_c, *geo)
    torch.testing.assert_close(img, img_p, rtol=0, atol=ATOL)
    torch.testing.assert_close(trans, trans_p, rtol=0, atol=ATOL)
    assert float(trans_p.min()) < 0.5  # the scene covers pixels
    # with a background, blended outside the kernel as the wrapper blends it
    bg = torch.linspace(0.1, 0.9, D, device=cuda_device)
    torch.testing.assert_close(img + trans[..., None] * bg, img_p + trans_p[..., None] * bg,
                               rtol=0, atol=ATOL)
    rng = np.random.default_rng(D)
    v_img = torch.from_numpy(rng.normal(size=tuple(img.shape)).astype(np.float32)).to(cuda_device)
    v_t = torch.from_numpy(rng.normal(size=tuple(trans.shape)).astype(np.float32)).to(cuda_device)
    before = _build.LAUNCHES.get(RP.KERNEL_BWD, 0)
    got = RP.rasterize_dense_bwd(rows_c, counts_c, *geo, img, trans, v_img, v_t)
    assert _build.LAUNCHES[RP.KERNEL_BWD] == before + 1
    want = RP.rasterize_dense_bwd_plain(rows_c, counts_c, *geo, img, trans, v_img, v_t)
    torch.cuda.synchronize()
    assert got.shape == want.shape == rows.shape and bool(torch.isfinite(got).all())
    for name, cols in GROUPS.items():
        assert _rel_err(got[..., cols], want[..., cols]) <= 1e-3, name
    slot = torch.arange(rows.shape[1], device=cuda_device)
    assert float(got[slot[None, :] >= counts_c[:, None].long()].abs().max()) == 0.0


@pytest.mark.cuda
def test_dense_wrappers_reject_bad_inputs(cuda_device):
    from tdgs_torch.ops import rasterize_pallas as RP

    rows, counts, _, _, _ = _dense_stream(210, 3, N=30)
    rows, counts = rows.to(cuda_device), counts.to(cuda_device)
    with pytest.raises(TypeError):  # int64 counts
        RP.rasterize_dense_fwd(rows, counts.long(), 1, W, H, 16)
    with pytest.raises(ValueError):  # rows for another image count
        RP.rasterize_dense_fwd(rows, counts, 2, W, H, 16)
    with pytest.raises(ValueError):  # operands on two devices
        RP.rasterize_dense_fwd(rows, counts.cpu(), 1, W, H, 16)
    with pytest.raises(ValueError):  # more channels than the kernels take
        wide = torch.zeros(rows.shape[:-1] + (6 + 33,), device=cuda_device)
        RP.rasterize_dense_fwd(wide, counts, 1, W, H, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("n_images", [1, 2])
def test_dense_autograd_on_card_matches_cpu(cuda_device, n_images):
    """The whole "pallas" rasterizer: the gather, kernels 9, 10 and the
    segment sum on the card against the plain versions on the CPU, with a
    background; gradients to every input."""
    from tdgs_torch.ops.rasterize_pallas import KERNEL_BWD, KERNEL_FWD, rasterize_to_pixels_pallas

    _, _, inputs, offsets, isect = _dense_stream(220, 3, n_images, tile_capacity=256)
    grads = {}
    for dev in ("cpu", cuda_device):
        rng = np.random.default_rng(220)
        leaves = [x.to(dev).clone().requires_grad_(True) for x in inputs]
        before = {k: _build.LAUNCHES.get(k, 0) for k in (KERNEL_FWD, KERNEL_BWD, S.KERNEL)}
        img, alp = rasterize_to_pixels_pallas(
            *leaves, W, H, 16, offsets.to(dev), isect.flatten_ids.to(dev), isect.n_isects,
            backgrounds=torch.tensor([[0.2, 0.5, 0.8]] * n_images, device=dev),
            tile_capacity=256)
        loss = sum((x * torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32))
                    .to(dev)).sum() for x in (img, alp))
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        launched = {k: _build.LAUNCHES.get(k, 0) - n for k, n in before.items()}
        assert launched == ({k: 1 for k in launched} if dev != "cpu"
                            else {k: 0 for k in launched})
    for name, g, w in zip(("means2d", "conics", "colors", "opacities"),
                          grads[str(cuda_device)], grads["cpu"]):
        assert _rel_err(g, w) <= 1e-3, name


@pytest.mark.cuda
def test_jax_rasterizer_on_card_matches_cpu(cuda_device):
    """The plain-tensor "jax" dense rasterizer on CUDA tensors against the
    same on the CPU, with the AbsGS tap: its backward sums through kernel 3
    and launches neither dense kernel."""
    from tdgs_torch.ops.rasterize_jax import rasterize_to_pixels_jax
    from tdgs_torch.ops.rasterize_pallas import KERNEL_BWD, KERNEL_FWD

    _, _, inputs, offsets, isect = _dense_stream(230, 3, 2, N=120, tile_capacity=256)
    G = inputs[0].shape[0] * inputs[0].shape[1]
    grads = {}
    for dev in ("cpu", cuda_device):
        rng = np.random.default_rng(230)
        leaves = [x.to(dev).clone().requires_grad_(True) for x in inputs]
        leaves.append(torch.zeros((G, 2), device=dev, requires_grad=True))
        before = {k: _build.LAUNCHES.get(k, 0) for k in (KERNEL_FWD, KERNEL_BWD, S.KERNEL)}
        img, alp = rasterize_to_pixels_jax(
            *leaves[:4], W, H, 16, offsets.to(dev), isect.flatten_ids.to(dev),
            isect.n_isects, backgrounds=torch.tensor([[0.2, 0.5, 0.8]] * 2, device=dev),
            tile_capacity=256, absgrad_dummy=leaves[4])
        loss = sum((x * torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32))
                    .to(dev)).sum() for x in (img, alp))
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        launched = {k: _build.LAUNCHES.get(k, 0) - n for k, n in before.items()}
        assert launched == {KERNEL_FWD: 0, KERNEL_BWD: 0,
                            S.KERNEL: 0 if dev == "cpu" else 1}
    for name, g, w in zip(("means2d", "conics", "colors", "opacities", "abs_tap"),
                          grads[str(cuda_device)], grads["cpu"]):
        assert float(w.abs().max()) > 0, name
        assert _rel_err(g, w) <= 1e-3, name
