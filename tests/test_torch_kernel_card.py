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
tile-dense kernels as kernels 1 and 2 are, and their launches cut into
several blocks a tile bit for bit as one block a tile.
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


def _stream(seed, D, N=300, min_radius=10, tile_size=16):
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
                               torch.from_numpy(depths), tile_size, -(-W // tile_size),
                               -(-H // tile_size),
                               max_tiles_per_gauss=16 * (16 // tile_size) ** 2)
    return dict(
        means2d=torch.from_numpy(means2d),
        conics=torch.from_numpy(conics.astype(np.float32)),
        colors=torch.from_numpy(rng.uniform(0, 1, size=(1, N, D)).astype(np.float32)),
        opacities=torch.from_numpy(rng.uniform(0.05, 0.95, size=(1, N)).astype(np.float32)),
        offsets=isect.offsets, flatten_ids=isect.flatten_ids,
    )


def _args(s, device, tile_size=16):
    t = {k: v.to(device) for k, v in s.items()}
    return (t["means2d"], t["conics"], t["colors"], t["opacities"], W, H, tile_size,
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


def _segment_layout(name, rng):
    """(stream ids, n_valid or None, mask or None, n_out) of a layout that
    the kernel's decomposition makes hard: each block owns a window of
    output rows (256 at rows of up to 16 columns, 128 at up to 24), splits
    the window's sorted positions into eight warps' spans, and each warp
    walks its span 32 positions a step."""
    n = 3_000
    if name == "one_id_over_many_warp_spans":  # off the 32-position grid
        ids = np.concatenate([rng.integers(0, 40, 13), np.full(77, 41),
                              rng.integers(42, n, 500)])
        return ids, None, None, n
    if name == "one_segment_over_all_eight_warps":
        # the first window holds ids 10, 11 and 12 only: id 11's 1,000
        # entries begin in warp 0's span and end in warp 7's, so warps 1-7
        # each hold a part of it in their carry rows
        ids = np.concatenate([np.full(5, 10), np.full(1_000, 11), np.full(7, 12),
                              rng.integers(256, n, 2_000)])
        return ids, None, None, n
    if name == "ids_straddling_window_edges":
        # segments of 1-40 entries on the last and first rows of every
        # window (each multiple of 128, so both window sizes), none between
        edges = np.arange(128, n, 128)
        edge_ids = np.concatenate([edges - 1, edges])
        ids = np.repeat(edge_ids, rng.integers(1, 41, edge_ids.size))
        return ids, None, None, n
    if name == "all_distinct":
        return rng.permutation(n)[:2_900], None, None, n
    if name == "empty_rows_at_both_ends":  # ids only in [700, 2100), with holes
        ids = rng.choice(np.arange(700, 2_100, 3), size=4_000)
        return ids, None, None, n
    if name == "no_entries":
        return np.zeros(0, np.int64), None, None, n
    if name == "entries_not_a_multiple_of_32":
        return rng.integers(0, n, 8 * 1_111 + 5), None, None, n
    if name == "all_padding":
        return rng.integers(0, n, 3_001), 0, None, n
    if name == "dense_masked":  # the dense path: only the valid slots sorted
        ids = rng.integers(0, n, 12_000)
        mask = rng.random(12_000) < 0.3
        return ids, None, mask, n
    raise ValueError(name)


SEGMENT_LAYOUTS = ["one_id_over_many_warp_spans", "one_segment_over_all_eight_warps",
                   "ids_straddling_window_edges", "all_distinct", "empty_rows_at_both_ends",
                   "no_entries", "entries_not_a_multiple_of_32", "all_padding",
                   "dense_masked"]


@pytest.mark.cuda
# 3DGS rows with the AbsGS columns, eval3d RGB rows, 2DGS RGB+ED rows with
# the AbsGS columns, eval3d rows of 32 channels (two column chunks)
@pytest.mark.parametrize("F,abs_cols", [(9, True), (16, False), (19, True), (45, False)])
@pytest.mark.parametrize("layout", SEGMENT_LAYOUTS)
def test_segment_sum_kernel_adversarial_layouts_on_card(cuda_device, layout, F, abs_cols):
    """Layouts that the kernel's windows and warp spans make hard, each
    column within 1e-5 of the plain version's scale, and two launches bit
    for bit equal."""
    rng = np.random.default_rng(SEGMENT_LAYOUTS.index(layout) + 100 * F)
    ids, n_valid, mask, n = _segment_layout(layout, rng)
    dev = cuda_device
    rows = torch.from_numpy(rng.normal(size=(max(len(ids), 1), F)).astype(np.float32)).to(dev)
    sids, perm = S.sort_ids(
        torch.from_numpy(ids.astype(np.int32)).to(dev),
        None if n_valid is None else torch.tensor(n_valid, device=dev),
        None if mask is None else torch.from_numpy(mask).to(dev))
    a = S.segment_rows_sum(rows, perm, sids, n, abs_cols=abs_cols)
    b = S.segment_rows_sum(rows, perm, sids, n, abs_cols=abs_cols)
    want = S.segment_rows_sum_plain(rows, perm, sids, n, abs_cols=abs_cols)
    torch.cuda.synchronize()
    assert torch.equal(a, b)  # deterministic, bit for bit
    assert a.shape == want.shape == (n, F + (2 if abs_cols else 0))
    for col in range(a.shape[1]):
        assert _rel_err(a[:, col], want[:, col]) <= 1e-5, col
    empty = want.abs().sum(1) == 0  # rows no sorted position names are zero
    assert float(a[empty].abs().sum()) == 0.0


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


def _surfel_stream(seed, D, n_images=1, N=300, tile_size=16):
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
    isect = isect_tiles_packed(means2d, radii, depths, tile_size, -(-W // tile_size),
                               -(-H // tile_size),
                               max_tiles_per_gauss=16 * (16 // tile_size) ** 2)
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
# every templated channel bound: kernel 7's 4, 8, 16, 32; kernel 8's 3, 8,
# 16, 32 (13 + D values padded to 16, 32, 32, 64)
@pytest.mark.parametrize("D", [1, 3, 8, 16, 32])
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
@pytest.mark.parametrize("D", [1, 3, 16, 32])  # 14, 16, 29 and 45 values in the reduction
def test_eval3d_bwd_kernel_is_bitwise_repeatable_on_card(cuda_device, D):
    """Two launches of kernel 8 on the same inputs agree bit for bit: the
    per-entry reduce-scatter and the block's sums take a fixed order."""
    from tdgs_torch.ops import rasterize_eval3d_packed as E

    s = _eval3d_stream(200 + D, D)
    dev = cuda_device
    geo = (s["rows"].to(dev), s["d"].to(dev), None, s["offsets"].to(dev), 1, D, W, H, 16)
    img, T = E.rasterize_eval3d_train_fwd(*geo, 1024)
    rng = np.random.default_rng(D)
    v_img, v_T = (torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(dev)
                  for x in (img, T))
    before = _build.LAUNCHES.get(E.KERNEL_BWD, 0)
    first = E.rasterize_eval3d_bwd(*geo, img, T, v_img, v_T, 1024)
    second = E.rasterize_eval3d_bwd(*geo, img, T, v_img, v_T, 1024)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[E.KERNEL_BWD] == before + 2
    assert float(first[0].abs().max()) > 0  # the entries get gradients
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


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


def _dense_stream(seed, D, n_images=1, N=300, tile_capacity=128, tile_size=16):
    """Random screen-space gaussians through the dense tiling and the
    per-tile gather, on the CPU: (rows [T, cap, 6 + D], counts, inputs)."""
    from tdgs_torch.ops.rasterize_pallas import dense_rows
    from tdgs_torch.ops.tiling import isect_offset_encode, isect_tiles

    rng = np.random.default_rng(seed)
    I = n_images
    tw, th = -(-W // tile_size), -(-H // tile_size)
    means2d = rng.uniform(0, [W, H], size=(I, N, 2)).astype(np.float32)
    A = rng.normal(size=(I, N, 2, 2)).astype(np.float32)
    cov = A @ np.swapaxes(A, -1, -2) + 2.0 * np.eye(2, dtype=np.float32)
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]], -1).astype(np.float32)
    radii = np.maximum(np.ceil(3.33 * np.sqrt(np.stack(
        [cov[..., 0, 0], cov[..., 1, 1]], -1))), 10).astype(np.int32)
    depths = rng.uniform(0.1, 10, size=(I, N)).astype(np.float32)
    isect = isect_tiles(torch.from_numpy(means2d), torch.from_numpy(radii),
                        torch.from_numpy(depths), tile_size, tw, th, capacity=I * N * tw * th,
                        max_tiles_per_gauss=tw * th)
    offsets = isect_offset_encode(isect.isect_keys, I, tw, th)
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


def _dense_both(RP, rows, counts, geo, seed):
    """Kernels 9 and 10 twice each and their plain versions on one set of
    rows: the forward (colours, T), the gradient rows for random
    cotangents."""
    fwd = [RP.rasterize_dense_fwd(rows, counts, *geo) for _ in range(2)]
    fwd_p = RP.rasterize_dense_fwd_plain(rows, counts, *geo)
    img, trans = fwd[0]
    rng = np.random.default_rng(seed)
    v_img, v_t = (torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32))
                  .to(x.device) for x in (img, trans))
    bwd = [RP.rasterize_dense_bwd(rows, counts, *geo, img, trans, v_img, v_t)
           for _ in range(2)]
    bwd_p = RP.rasterize_dense_bwd_plain(rows, counts, *geo, img, trans, v_img, v_t)
    torch.cuda.synchronize()
    return fwd, fwd_p, bwd, bwd_p, (img, trans, v_img, v_t)


def _assert_dense(fwd, fwd_p, bwd, bwd_p, counts):
    """Both launches bit for bit equal; the forward within ATOL of the plain
    version, each gradient group within 1e-3 of its scale; the gradient rows
    past each tile's count exactly zero."""
    for a, b in zip(*fwd):
        assert torch.equal(a, b)
    for g, w in zip(fwd[0], fwd_p):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    first, second = bwd
    assert torch.equal(first, second)
    assert first.shape == bwd_p.shape and bool(torch.isfinite(first).all())
    for name, cols in GROUPS.items():
        assert _rel_err(first[..., cols], bwd_p[..., cols]) <= 1e-3, name
    slot = torch.arange(first.shape[1], device=first.device)
    past = slot[None, :] >= counts[:, None].long()
    if bool(past.any()):
        assert float(first[past].abs().max()) == 0.0


@pytest.mark.cuda
# kernel 10 reduces 6 + D = 7, 9, 10 values over 16 lanes, 22 over 32 and
# 38 over 64; 8-pixel tiles make 64-thread blocks
@pytest.mark.parametrize("D,tile_size", [(1, 16), (3, 16), (4, 16), (16, 16), (32, 16), (3, 8)])
def test_dense_kernels_are_bitwise_repeatable_on_card(cuda_device, D, tile_size):
    from tdgs_torch.ops import rasterize_pallas as RP

    rows, counts, _, _, _ = _dense_stream(240 + D, D, tile_size=tile_size)
    rows, counts = rows.to(cuda_device), counts.to(cuda_device)
    fwd, fwd_p, bwd, bwd_p, _ = _dense_both(RP, rows, counts, (1, W, H, tile_size), D)
    assert float(bwd[0].abs().max()) > 0
    _assert_dense(fwd, fwd_p, bwd, bwd_p, counts)


DENSE_LAYOUTS = ["tiles_of_0_1_31_32_33_entries", "tile_cut_at_capacity_128",
                 "tile_count_equals_capacity_256", "every_pixel_cut_off_in_the_first_batch",
                 "dead_warps_beside_a_live_one"]


def _dense_layout_rows(name, rng, D=3):
    """Rows [6, cap, 6 + D] and counts for the 3 x 2 tiles of LW x LH from
    ``_bwd_layout``'s entries: each a gaussian of the entry's size with a
    random covariance; slots past a tile's count hold random rows, which
    the kernels must never read."""
    layout = {"tile_cut_at_capacity_128": "tile_truncated_at_128",
              "tile_count_equals_capacity_256": "tiles_of_0_1_31_32_33_entries"}.get(name, name)
    tiles, _ = _bwd_layout(layout, rng)
    cap = 128
    if name == "tile_count_equals_capacity_256":
        cap = 256
        tiles[2] = np.stack([32 + rng.uniform(-4, 20, cap), rng.uniform(-4, 20, cap),
                             rng.uniform(1.0, 6.0, cap), rng.uniform(0.02, 0.2, cap)], -1)
    rows = rng.normal(size=(len(tiles), cap, 6 + D)).astype(np.float32)
    counts = np.zeros(len(tiles), np.int32)
    for t, ent in enumerate(tiles):
        ent = ent[:cap]  # the gather keeps a tile's first cap entries
        counts[t] = len(ent)
        for k, (cx, cy, size, op) in enumerate(ent):
            B = rng.normal(size=(2, 2))
            cov = size ** 2 * (B @ B.T / np.trace(B @ B.T) * 2 + 0.1 * np.eye(2))
            inv = np.linalg.inv(cov)
            rows[t, k, :6] = [cx, cy, inv[0, 0], inv[0, 1], inv[1, 1], op]
            rows[t, k, 6:] = rng.uniform(0, 1, D)
    return torch.from_numpy(rows), torch.from_numpy(counts)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", DENSE_LAYOUTS)
def test_dense_kernels_adversarial_layouts_on_card(cuda_device, layout):
    """Kernels 9 and 10 (D = 3) on tiles of few, many, cut and dead slots:
    within tolerance of the plain versions, two launches bit for bit equal,
    zero gradient rows past each count and past the walks; the split
    launches bitwise equal to one block a tile."""
    from tdgs_torch.ops import rasterize_pallas as RP

    rng = np.random.default_rng(60 + DENSE_LAYOUTS.index(layout))
    rows, counts = (x.to(cuda_device) for x in _dense_layout_rows(layout, rng))
    geo = (1, LW, LH, 16)
    fwd, fwd_p, bwd, bwd_p, cot = _dense_both(RP, rows, counts, geo, 9)
    assert float(bwd[0].abs().max()) > 0
    _assert_dense(fwd, fwd_p, bwd, bwd_p, counts)
    if layout == "tile_cut_at_capacity_128":
        assert int(counts[4]) == rows.shape[1] == 128
    if layout == "tile_count_equals_capacity_256":
        assert int(counts[2]) == rows.shape[1] == 256
    if layout == "every_pixel_cut_off_in_the_first_batch":
        assert float(bwd[0][2, 32:].abs().max()) == 0.0
    for s in (2, 8):
        assert all(torch.equal(a, b) for a, b in
                   zip(RP._launch_dense_fwd(rows, counts, *geo, n_split=s), fwd[0]))
        assert torch.equal(RP._launch_dense_bwd(rows, counts, *geo, *cot, n_split=s), bwd[0])


@pytest.mark.cuda
@pytest.mark.parametrize("D,tile_size", [(3, 16), (16, 16), (3, 8)])
def test_dense_kernels_split_equals_unsplit_on_card(cuda_device, D, tile_size):
    """At a few tiles the wrappers cut each tile into several blocks (kernel
    9: its warps; kernel 10: ranges of its slots, each block replaying the
    walk before its range): the output is bitwise that of one block a
    tile, at every split count."""
    from tdgs_torch.ops import rasterize_pallas as RP

    rows, counts, _, _, _ = _dense_stream(250 + D, D, tile_size=tile_size, tile_capacity=256)
    rows, counts = rows.to(cuda_device), counts.to(cuda_device)
    geo = (1, W, H, tile_size)
    T = rows.shape[0]
    warps = tile_size * tile_size // 32
    assert RP.split_count(T, cuda_device, warps) > 1  # the wrappers take the split
    assert RP.split_count(T, cuda_device, RP.MAX_RANGES) > 1
    assert int(counts.max()) > 3 * 32  # several ranges of 32 slots hold slots
    one = RP._launch_dense_fwd(rows, counts, *geo, n_split=1)
    for s in [d for d in (2, 4, 8) if warps % d == 0]:
        got = RP._launch_dense_fwd(rows, counts, *geo, n_split=s)
        assert all(torch.equal(a, b) for a, b in zip(got, one)), s
    assert all(torch.equal(a, b) for a, b in zip(RP.rasterize_dense_fwd(rows, counts, *geo), one))
    img, trans = one
    rng = np.random.default_rng(D)
    cot = [torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(cuda_device)
           for x in (img, trans)]
    ref = RP._launch_dense_bwd(rows, counts, *geo, img, trans, *cot, n_split=1)
    for s in (2, 3, 4, 8):
        assert torch.equal(RP._launch_dense_bwd(rows, counts, *geo, img, trans, *cot, n_split=s),
                           ref), s
    assert torch.equal(RP.rasterize_dense_bwd(rows, counts, *geo, img, trans, *cot), ref)
    want = RP.rasterize_dense_bwd_plain(rows, counts, *geo, img, trans, *cot)
    for name, cols in GROUPS.items():
        assert _rel_err(ref[..., cols], want[..., cols]) <= 1e-3, name


# ---------------------------------------------------------------------------
# Kernels 2 and 6: repeatability at every reduction width, and tile layouts
# that the batches of 32 entries, the warps and the cut make hard
# ---------------------------------------------------------------------------

GROUPS_2DGS = {"means2d": slice(0, 2), "t0_tpx_tpy": slice(2, 11), "opacity": slice(11, 12),
               "channels": slice(12, None)}


def _bwd_2dgs(R, geo, tile_capacity, seed):
    """Kernel 6 twice and its plain version on one stream (the training
    forward's outputs, random cotangents)."""
    D = geo[3]
    train = R.rasterize_2dgs_train_fwd(*geo, tile_capacity, D - 1, True)
    rng = np.random.default_rng(seed)
    cot = [torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(x.device)
           for x in train[:4]]
    before = _build.LAUNCHES.get(R.KERNEL_BWD, 0)
    first = R.rasterize_2dgs_bwd(*geo, *train[:4], *cot, tile_capacity, D - 1, True)
    second = R.rasterize_2dgs_bwd(*geo, *train[:4], *cot, tile_capacity, D - 1, True)
    assert _build.LAUNCHES[R.KERNEL_BWD] == before + 2
    want = R.rasterize_2dgs_bwd_plain(*geo, *train[:4], *cot, tile_capacity, D - 1, True)
    torch.cuda.synchronize()
    return first, second, want


def _bwd_packed(args, tile_capacity, seed):
    """Kernel 2 twice and its plain version on one stream."""
    img, trans = rasterize_packed_train_fwd(*args, tile_capacity=tile_capacity)
    rng = np.random.default_rng(seed)
    v_img, v_t = (torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32))
                  .to(x.device) for x in (img, trans))
    before = _build.LAUNCHES.get(KERNEL_BWD, 0)
    first = rasterize_packed_bwd(*args, img, trans, v_img, v_t, tile_capacity=tile_capacity)
    second = rasterize_packed_bwd(*args, img, trans, v_img, v_t, tile_capacity=tile_capacity)
    assert _build.LAUNCHES[KERNEL_BWD] == before + 2
    want = rasterize_packed_bwd_plain(*args, img, trans, v_img, v_t,
                                      tile_capacity=tile_capacity)
    torch.cuda.synchronize()
    return first, second, want


def _assert_rows(first, second, want, groups, n_valid):
    """Bitwise repeatable, each gradient group within 1e-3 of the plain
    version's scale, the stream's padding zero."""
    assert torch.equal(first, second)
    assert first.shape == want.shape
    assert bool(torch.isfinite(first).all())
    for name, cols in groups.items():
        assert _rel_err(first[:, cols], want[:, cols]) <= 1e-3, name
    assert first.shape[0] > n_valid  # the stream has padding slots
    assert float(first[n_valid:].abs().max()) == 0.0


@pytest.mark.cuda
# 12 + D + 3 values: 16 (16 lanes), 19 (16 with the d tpy columns from the
# half-warps' rows), 32 and 47; D = 4 at 8-pixel tiles, whose half-warps
# are not pixel rows, reduces all 19 over 32 lanes
@pytest.mark.parametrize("D,tile_size", [(1, 16), (4, 16), (17, 16), (32, 16), (4, 8)])
def test_2dgs_bwd_kernel_is_bitwise_repeatable_on_card(cuda_device, D, tile_size):
    from tdgs_torch.ops import rasterize_2dgs_packed as R

    s = _surfel_stream(210 + D, D, tile_size=tile_size)
    geo = (s["rows"].to(cuda_device), s["offsets"].to(cuda_device), 1, D, W, H, tile_size)
    first, second, want = _bwd_2dgs(R, geo, 1024, D)
    assert float(first[:, GROUPS_2DGS["t0_tpx_tpy"]].abs().max()) > 0  # the σ3d branch
    _assert_rows(first, second, want, GROUPS_2DGS, int(s["offsets"][-1]))


@pytest.mark.cuda
# 4 + D = 7 values (8 lanes, the half-warp rows' moments); 6 + D = 16 (16
# lanes), 32, 38 (64); D = 3 at 8-pixel tiles, whose half-warps are not
# pixel rows, reduces 9 over 16 lanes
@pytest.mark.parametrize("D,tile_size", [(3, 16), (10, 16), (26, 16), (32, 16), (3, 8)])
def test_bwd_kernel_is_bitwise_repeatable_on_card(cuda_device, D, tile_size):
    s = _stream(220 + D, D, tile_size=tile_size)
    first, second, want = _bwd_packed(_args(s, cuda_device, tile_size), 1024, D)
    assert float(first.abs().max()) > 0
    _assert_rows(first, second, want, GROUPS, int(s["offsets"][-1]))


LW, LH = 48, 32  # 3 x 2 tiles of 16 pixels
BWD_LAYOUTS = ["tiles_of_0_1_31_32_33_entries", "tile_truncated_at_128",
               "dead_warps_beside_a_live_one", "every_pixel_cut_off_in_the_first_batch",
               "batches_at_unaligned_row_offsets"]


def _bwd_layout(name, rng):
    """Entries tile by tile: (cx, cy, size, opacity) per entry, and the
    tile capacity. Sizes are in pixels; below about 0.7 the 2DGS kernel
    takes the σ2d branch."""
    def entries(tile, n, size=(1.0, 6.0), op=(0.05, 0.95)):
        ox, oy = 16 * (tile % 3), 16 * (tile // 3)
        return np.stack([ox + rng.uniform(-4, 20, n), oy + rng.uniform(-4, 20, n),
                         rng.uniform(*size, n), rng.uniform(*op, n)], -1)

    tiles = [np.zeros((0, 4))] * 6
    tile_capacity = 1024
    if name == "tiles_of_0_1_31_32_33_entries":
        tiles = [entries(t, n) for t, n in enumerate([0, 1, 31, 32, 33, 64])]
    elif name == "tile_truncated_at_128":  # 300 faint entries, cut at 128
        tiles[4] = entries(4, 300, op=(0.02, 0.1))
        tiles[0] = entries(0, 20)
        tile_capacity = 128
    elif name == "dead_warps_beside_a_live_one":
        # small faint entries on pixel row 0 of tile 1: only its warp 0
        # (rows 0-1) sees them; warp 1 (rows 2-3) and the rest stay dead
        e = entries(1, 40, size=(0.2, 0.3), op=(0.05, 0.15))
        e[:, 1] = 0.5
        tiles[1] = e
        tiles[3] = entries(3, 5)
    elif name == "every_pixel_cut_off_in_the_first_batch":
        # wide, nearly opaque entries end every pixel's walk at the second
        # entry; the other 78 get zero rows
        e = entries(2, 80)
        e[:3] = [40.0, 8.0, 60.0, 0.995]
        tiles[2] = e
    elif name == "batches_at_unaligned_row_offsets":
        # tile 1 starts at stream slot 1: its batches' rows begin off the
        # 16-byte grid for every odd row width
        tiles[0] = entries(0, 1)
        tiles[1] = entries(1, 70)
        tiles[5] = entries(5, 45)
    else:
        raise ValueError(name)
    return tiles, tile_capacity


def _layout_stream(tiles, n_pad=37):
    offsets = np.concatenate([[0], np.cumsum([len(t) for t in tiles])]).astype(np.int32)
    ent = np.concatenate(tiles)
    return ent, torch.from_numpy(offsets), len(ent) + n_pad


def _layout_rows_2dgs(ent, L, D, rng):
    """Surfel rows [L, 12 + D + 3] with tmp = M (px, py, 1): tmpx, tmpy a
    random rotation and stretch of (p - c) / size, tmpz = 1 + a slight
    tilt, so σ3d ≈ |p - c|² / size²; padding rows random."""
    n = len(ent)
    rows = rng.normal(size=(L, 12 + D + 3)).astype(np.float32)
    for i, (cx, cy, size, op) in enumerate(ent):
        th = rng.uniform(0, np.pi)
        A = (np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
             @ np.diag(rng.uniform(0.7, 1.4, 2)) / size)
        tilt = rng.uniform(-0.01, 0.01, 2)
        M = np.zeros((3, 3))
        M[:2, :2] = A
        M[:2, 2] = -A @ [cx, cy]
        M[2] = [tilt[0], tilt[1], 1.0 - tilt @ [cx, cy]]
        rows[i, :12] = [cx, cy, *M[:, 2], *M[:, 0], *M[:, 1], op]
        rows[i, 12:] = rng.uniform(0, 1, D + 3)
    rows[:n, 12 + D - 1] = rng.uniform(1, 10, n)  # the depth channel
    return torch.from_numpy(rows)


def _layout_args_packed(ent, offsets, L, D, rng):
    """Kernel 2's operands: one gaussian per entry at (cx, cy) with a
    random covariance of the entry's size, flatten_ids in stream order and
    zero ids in the padding."""
    n = len(ent)
    means2d = ent[:, :2][None].astype(np.float32)
    conics = np.zeros((1, n, 3), np.float32)
    for i, size in enumerate(ent[:, 2]):
        B = rng.normal(size=(2, 2))
        cov = size ** 2 * (B @ B.T / np.trace(B @ B.T) * 2 + 0.1 * np.eye(2))
        inv = np.linalg.inv(cov)
        conics[0, i] = [inv[0, 0], inv[0, 1], inv[1, 1]]
    ids = np.zeros(L, np.int32)
    ids[:n] = np.arange(n)
    return (torch.from_numpy(means2d), torch.from_numpy(conics),
            torch.from_numpy(rng.uniform(0, 1, (1, n, D)).astype(np.float32)),
            torch.from_numpy(ent[:, 3][None].astype(np.float32)), LW, LH, 16, offsets,
            torch.from_numpy(ids))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", BWD_LAYOUTS)
def test_2dgs_bwd_kernel_adversarial_layouts_on_card(cuda_device, layout):
    """Kernel 6 (RGB+ED, D = 4, the half-warp rows' reduction) on layouts
    of few, many, cut and dead entries: within 1e-3 of the plain version,
    two launches bit for bit equal, zero rows past the walks and in the
    padding."""
    from tdgs_torch.ops import rasterize_2dgs_packed as R

    rng = np.random.default_rng(BWD_LAYOUTS.index(layout))
    tiles, tc = _bwd_layout(layout, rng)
    ent, offsets, L = _layout_stream(tiles)
    D = 4
    rows = _layout_rows_2dgs(ent, L, D, rng)
    geo = (rows.to(cuda_device), offsets.to(cuda_device), 1, D, LW, LH, 16)
    first, second, want = _bwd_2dgs(R, geo, tc, 7)
    assert float(first.abs().max()) > 0
    _assert_rows(first, second, want, GROUPS_2DGS, len(ent))
    if layout == "every_pixel_cut_off_in_the_first_batch":
        start = int(offsets[2])
        assert float(first[start + 32:start + 80].abs().max()) == 0.0
    if layout == "tile_truncated_at_128":
        start = int(offsets[4])
        assert float(first[start + 128:start + 300].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", BWD_LAYOUTS)
def test_bwd_kernel_adversarial_layouts_on_card(cuda_device, layout):
    """Kernel 2 (D = 3) on the same layouts as kernel 6."""
    rng = np.random.default_rng(50 + BWD_LAYOUTS.index(layout))
    tiles, tc = _bwd_layout(layout, rng)
    ent, offsets, L = _layout_stream(tiles)
    args = tuple(a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                 for a in _layout_args_packed(ent, offsets, L, 3, rng))
    first, second, want = _bwd_packed(args, tc, 8)
    assert float(first.abs().max()) > 0
    _assert_rows(first, second, want, GROUPS, len(ent))
    if layout == "every_pixel_cut_off_in_the_first_batch":
        start = int(offsets[2])
        assert float(first[start + 32:start + 80].abs().max()) == 0.0
    if layout == "tile_truncated_at_128":
        start = int(offsets[4])
        assert float(first[start + 128:start + 300].abs().max()) == 0.0
