"""The CUDA kernels against their plain PyTorch versions, on the card: the
compositing forward (kernel 1), its backward (kernel 2), the sorted
segment sum (kernel 3), the 2DGS forwards (kernels 4 and 5) and
backward (kernel 6), the eval3d (3DGUT) forward (kernel 7) and
backward (kernel 8), and the tile-dense forward (kernel 9) and backward
(kernel 10); and the sharded renders of ``tdgs_torch.parallel`` on worlds
of 2 and 4 ranks sharing the card, which run those kernels through the
exchange, each against the single-rank render of its cameras. The small
streams here reach every templated width, layout and cut; the last section
holds every kernel again at full size (``tests/card_scenes.py``: the
200k-gaussian 1080p bench scene at its paths' shapes), where a fault that
only size exposes shows. ``tests/test_torch_paths_card.py`` holds the
paths that launch them.

The kernels have no CPU mode, so every test here is marked ``cuda`` and skips
without a card. The file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_card.py

Tolerances (``tests/card_scenes.py``), small streams and full size alike:
1e-3 absolute for the forward (the kernel accumulates colours in a running
sum, the plain version in a matrix product); max|Δ| / max|plain| ≤ 1e-3 per
gradient group for the backward (the kernel sums 256 pixels by shuffles, the
plain version with ``sum``); 1e-5 relative per column for the segment sum, whose two
launches must agree bit for bit. The 2DGS kernels are held as kernels 1
and 2 are, with the distortion and the gradient groups relative to their
scale and median depth, a selected entry, allowed to differ in 1% of the
pixels (the bar set when the plain version's cumprod rounded its running
product otherwise than the kernel at the cutoffs; ``left_to_right`` now
recomputes such rows as the kernel multiplies). The eval3d kernels are held as
kernels 1 and 2 are, the ray gradients per group like the rows; the
tile-dense kernels as kernels 1 and 2 are, and their launches cut into
several blocks a tile bit for bit as one block a tile.
"""

import numpy as np
import pytest
import torch

import tdgs_torch
from tdgs_torch.ops import _build
from tdgs_torch.ops import rasterize_2dgs_packed as R2
from tdgs_torch.ops import rasterize_eval3d_packed as E
from tdgs_torch.ops import rasterize_pallas as RP
from tdgs_torch.ops import segment_sum as S
from tdgs_torch.ops.rasterize_packed import (
    KERNEL,
    KERNEL_BWD,
    max_entries_per_tile,
    rasterize_packed_bwd,
    rasterize_packed_bwd_plain,
    rasterize_packed_train_fwd,
    rasterize_packed_train_fwd_plain,
    rasterize_to_pixels_packed,
    rasterize_to_pixels_packed_inference,
    rasterize_to_pixels_packed_inference_plain,
    left_to_right,
)
from tdgs_torch.ops.tiling import isect_tiles_packed
from tdgs_torch.parallel import checks, launch
from tests import card_scenes as C

ATOL = C.TOL
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


# prefix opacities that keep a row's product above each cutoff
PREFIX_OPACITY = {1e-4: (0.02, 0.2), 0.5: (0.004, 0.015)}


def near_cutoff_opacities(rng, n, cut, L=41):
    """[n, L] float32 opacities, every α in [1/255, 0.999], whose
    left-to-right float32 product of (1 − α) ends within 1e-6 (relative)
    of ``cut``: rows on which two orders of the product may decide
    ``> cut`` differently at the last entry."""
    rows = []
    while len(rows) < n:
        ops = rng.uniform(*PREFIX_OPACITY[cut], size=(4096, L)).astype(np.float32)
        one = np.float32(1)
        p = np.multiply.accumulate(one - ops[:, :-1], axis=-1, dtype=np.float32)[:, -1]
        ops[:, -1] = (1.0 - cut / p.astype(np.float64)).astype(np.float32)
        end = np.multiply.accumulate(one - ops, axis=-1, dtype=np.float32)[:, -1]
        keep = ((np.abs(end / cut - 1.0) <= 1e-6) & (ops[:, -1] >= 1.0 / 255.0)
                & (ops[:, -1] <= 0.999))
        rows.extend(ops[keep])
    return np.stack(rows[:n])


def cutoff_stream(ops, D=3, seed=0, tile_size=16):
    """A packed stream whose tile t holds the L entries of ``ops[t]`` in
    order, over zero conics (σ = 0, so α is the opacity itself at every
    pixel), on an image of one row of tiles; colours random in [0.5, 1]."""
    n, L = ops.shape
    rng = np.random.default_rng(seed)
    N = n * L
    return dict(
        means2d=torch.zeros((1, N, 2)), conics=torch.zeros((1, N, 3)),
        colors=torch.from_numpy(rng.uniform(0.5, 1, size=(1, N, D)).astype(np.float32)),
        opacities=torch.from_numpy(ops.reshape(1, N)),
        offsets=torch.arange(0, N + 1, L, dtype=torch.int32),
        flatten_ids=torch.arange(N, dtype=torch.int32),
        width=n * tile_size, height=tile_size,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("cut", sorted(PREFIX_OPACITY))
def test_plain_products_decide_cutoffs_left_to_right_on_card(cuda_device, cut):
    """The plain versions' running product on the card (a tree-ordered
    cumprod, repaired by ``left_to_right``) decides every ``> cut`` test as
    the kernels' left-to-right float32 product does."""
    ops = near_cutoff_opacities(np.random.default_rng(7), 4096, cut)
    one_minus = 1.0 - torch.from_numpy(ops).to(cuda_device)
    got = left_to_right(torch.cumprod(one_minus, dim=-1), one_minus).cpu().numpy()
    want = np.multiply.accumulate(np.float32(1) - ops, axis=-1, dtype=np.float32)
    for c in PREFIX_OPACITY:
        np.testing.assert_array_equal(got > np.float32(c), want > np.float32(c))


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_cutoff_on_card(cuda_device):
    """Kernel 1 against the plain version on 1024 tiles whose products end
    within ulps of the 1e-4 cutoff, where the last entry weighs α·T of
    about 1e-2: they agree to 1e-5, so they included the same entries."""
    ops = near_cutoff_opacities(np.random.default_rng(8), 1024, 1e-4)
    s = cutoff_stream(ops)
    t = {k: v.to(cuda_device) for k, v in s.items() if torch.is_tensor(v)}
    args = (t["means2d"], t["conics"], t["colors"], t["opacities"], s["width"], s["height"],
            16, t["offsets"], t["flatten_ids"])
    got = rasterize_to_pixels_packed_inference(*args)
    want = rasterize_to_pixels_packed_inference_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


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


def _assert_k123(args, tile_capacity, seed):
    """Kernel 1's training call, kernel 2 and kernel 3 on the same stream
    against their plain versions, random cotangents: ATOL; kernel 2 bit for
    bit repeatable, each gradient group within 1e-3 of its scale; kernel 3
    (with and without the AbsGS columns) bit for bit repeatable, each
    column within 1e-5 of its scale."""
    tc = tile_capacity
    img, trans = rasterize_packed_train_fwd(*args, tile_capacity=tc)
    img_p, trans_p = rasterize_packed_train_fwd_plain(*args, tile_capacity=tc)
    torch.testing.assert_close(img, img_p, rtol=0, atol=ATOL)
    torch.testing.assert_close(trans, trans_p, rtol=0, atol=ATOL)
    rows, again, rows_p = _bwd_packed(args, tc, seed)
    assert torch.equal(rows, again) and bool(torch.isfinite(rows).all())
    for name, cols in GROUPS.items():
        assert _rel_err(rows[:, cols], rows_p[:, cols]) <= C.BWD_RTOL, name
    offsets, ids = args[7], args[8]
    G, D = args[0].numel() // 2, args[2].shape[-1]
    sids, perm = S.sort_ids(ids, offsets[-1])
    for abs_cols in (False, True):
        a = S.segment_rows_sum(rows, perm, sids, G, abs_cols=abs_cols)
        b = S.segment_rows_sum(rows, perm, sids, G, abs_cols=abs_cols)
        want_s = S.segment_rows_sum_plain(rows, perm, sids, G, abs_cols=abs_cols)
        torch.cuda.synchronize()
        assert a.shape[1] == 6 + D + (2 if abs_cols else 0)
        assert torch.equal(a, b)
        for col in range(a.shape[1]):
            assert _rel_err(a[:, col], want_s[:, col]) <= C.SEG_RTOL, (abs_cols, col)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 16])
def test_kernels_1_to_3_at_the_chain_shapes_on_card(cuda_device, D):
    """The domino chain's shapes: tiles longer than the rally's
    tile_capacity of 2048, and the identity render's D = 16 through kernel
    1's inference and training calls, kernel 2 (its CMAX = 26 build: 32
    values in the reduce-scatter) and kernel 3 (rows of 22 columns, 24 with
    the AbsGS columns), each against its plain version."""
    tc = 2048
    s = _stream(140 + D, D, N=3000, min_radius=40)  # every gaussian on every tile
    args = _args(s, cuda_device)
    assert int(torch.diff(s["offsets"].long()).max()) > tc  # the cut is live
    _assert_k1(args, tc, torch.linspace(0.1, 0.9, D, device=cuda_device)[None])
    _assert_k123(args, tc, seed=D)


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
    from tdgs_torch.ops.rasterize_2dgs_packed import feature_rows, padded_width

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
    feats = feature_rows(means2d, M, colors, normals, opac, width=padded_width(D))
    return dict(rows=feats[isect.flatten_ids.long(), :12 + D + 3].contiguous(),
                feats=feats, offsets=isect.offsets, means2d=means2d, ray_transforms=M,
                colors=colors, normals=normals, opacities=opac, flatten_ids=isect.flatten_ids)


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
    feats, ids = s["feats"].to(cuda_device), s["flatten_ids"].to(cuda_device)
    I, tc = n_images, tile_capacity
    geo = (rows, offs, I, D, W, H, 16)
    bg = torch.linspace(0.1, 0.9, D, device=cuda_device).repeat(I, 1)

    before = {k: _build.LAUNCHES.get(k, 0) for k in (R.KERNEL_FWD, R.KERNEL_TRAIN, R.KERNEL_BWD)}
    got = R.rasterize_2dgs_inference(feats, ids, *geo[1:], bg, tc)
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
    feats, ids = s["feats"].to(cuda_device), s["flatten_ids"].to(cuda_device)
    with pytest.raises(TypeError):  # int64 offsets
        R.rasterize_2dgs_inference(feats, ids, offs.long(), 1, 4, W, H, 16)
    with pytest.raises(ValueError):  # rows of the wrong width for D
        R.rasterize_2dgs_train_fwd(rows, offs, 1, 5, W, H, 16)
    with pytest.raises(ValueError):  # unpadded per-gaussian rows
        R.rasterize_2dgs_inference(feats[:, :19].contiguous(), ids, offs, 1, 4, W, H, 16)
    with pytest.raises(ValueError):  # operands on two devices
        R.rasterize_2dgs_inference(feats, ids, offs.cpu(), 1, 4, W, H, 16)
    with pytest.raises(TypeError):  # int64 flatten ids
        R.rasterize_2dgs_inference(feats, ids.long(), offs, 1, 4, W, H, 16)
    with pytest.raises(ValueError):  # flatten ids on another device
        R.rasterize_2dgs_inference(feats, ids.cpu(), offs, 1, 4, W, H, 16)
    with pytest.raises(ValueError):  # a split that does not divide the tile's warps
        R.rasterize_2dgs_train_fwd(rows, offs, 1, 4, W, H, 16, n_split=3)
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

    before = {k: _build.LAUNCHES.get(k, 0) for k in (E.KERNEL_FWD, E.KERNEL_TRAIN, E.KERNEL_BWD)}
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
    # the forward-only call and the training call count apart
    assert after[E.KERNEL_FWD] == before[E.KERNEL_FWD] + 1
    assert after[E.KERNEL_TRAIN] == before[E.KERNEL_TRAIN] + 1
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


# ---------------------------------------------------------------------------
# Kernels 1 and 7: the contract of each call, and the per-warp culls on
# layouts that graze them
# ---------------------------------------------------------------------------


def _k1_stream(seed, D, n_images=1, tile_size=16, N=300):
    """Kernel 1's operands for ``n_images`` images of random screen-space
    gaussians, tiled by the port on the CPU."""
    rng = np.random.default_rng(seed)
    I = n_images
    means2d = rng.uniform(0, [W, H], size=(I, N, 2)).astype(np.float32)
    A = rng.normal(size=(I, N, 2, 2)).astype(np.float32)
    cov = A @ np.swapaxes(A, -1, -2) + 2.0 * np.eye(2, dtype=np.float32)
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]], -1)
    radii = np.maximum(np.ceil(3.33 * np.sqrt(np.stack(
        [cov[..., 0, 0], cov[..., 1, 1]], -1))), 10).astype(np.int32)
    depths = rng.uniform(0.1, 10, size=(I, N)).astype(np.float32)
    isect = isect_tiles_packed(torch.from_numpy(means2d), torch.from_numpy(radii),
                               torch.from_numpy(depths), tile_size, -(-W // tile_size),
                               -(-H // tile_size),
                               max_tiles_per_gauss=16 * (16 // tile_size) ** 2)
    return (torch.from_numpy(means2d), torch.from_numpy(conics.astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 1, size=(I, N, D)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.05, 0.95, size=(I, N)).astype(np.float32)),
            W, H, tile_size, isect.offsets, isect.flatten_ids)


def _assert_k1(args, tile_capacity, bg, tiles=None):
    """Kernel 1's inference call (with ``bg``) and training call: within
    ATOL of the plain versions (on the pixels of ``tiles``, default all),
    two launches bit for bit equal, and the output bitwise independent of
    the blocks each tile is cut into."""
    from tdgs_torch.ops import rasterize_packed as P

    tc = tile_capacity
    warps = args[6] * args[6] // 32
    got = P.rasterize_to_pixels_packed_inference(*args, backgrounds=bg, tile_capacity=tc)
    train = P.rasterize_packed_train_fwd(*args, tile_capacity=tc)
    want = P.rasterize_to_pixels_packed_inference_plain(*args, backgrounds=bg, tile_capacity=tc)
    want_train = P.rasterize_packed_train_fwd_plain(*args, tile_capacity=tc)
    torch.cuda.synchronize()
    mask = torch.ones(want[1].shape[:-1], dtype=torch.bool, device=want[1].device)
    if tiles is not None:
        mask = tiles
    for g, w in ((got[0], want[0]), (got[1], want[1]), (train[0], want_train[0]),
                 (train[1][..., None], want_train[1][..., None])):
        assert bool(torch.isfinite(g[mask]).all())
        torch.testing.assert_close(g[mask], w[mask], rtol=0, atol=ATOL)
    again = P.rasterize_to_pixels_packed_inference(*args, backgrounds=bg, tile_capacity=tc)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for s in [d for d in (1, 2, 4, 8) if warps % d == 0]:
        split = P._launch_fwd(*args, bg, tc, False, n_split=s)
        assert all(torch.equal(a, b.reshape(a.shape)) for a, b in zip(got, split)), s
        split = P._launch_fwd(*args, None, tc, True, n_split=s)
        assert torch.equal(split[0], train[0]) and torch.equal(split[1][..., 0], train[1]), s
    return got, train


@pytest.mark.cuda
# every templated channel bound (4, 8, 16, 32), tiles of 16 and 8 pixels,
# one and two images
@pytest.mark.parametrize("D,tile_size,n_images", [(1, 16, 1), (3, 16, 2), (4, 8, 1),
                                                  (8, 16, 1), (16, 8, 2), (32, 16, 1)])
def test_kernel_1_calls_on_card(cuda_device, D, tile_size, n_images):
    """Kernel 1's inference call with backgrounds and its training call,
    with and without the cut at tile_capacity = 128: within ATOL of the
    plain versions, bitwise repeatable and independent of the split."""
    args = tuple(a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                 for a in _k1_stream(300 + D, D, n_images, tile_size))
    assert int(torch.diff(args[7].long()).max()) > 128  # some tile is cut
    bg = torch.linspace(0.1, 0.9, D, device=cuda_device).repeat(n_images, 1)
    for tc in (128, 1024):
        got, _ = _assert_k1(args, tc, bg)
    assert float(got[1].max()) > 0.5  # the gaussians cover pixels


CULL_LAYOUTS_K1 = ["tiles_of_0_1_31_32_33_entries", "tile_truncated_at_128",
                   "every_pixel_cut_off_in_the_first_batch", "means_inside_one_warp",
                   "grazing_the_threshold", "op_at_1_255", "scales_1e-4_against_1",
                   "nan_rows"]


def _k1_cull_layout(name, rng, D=3):
    """Kernel 1's operands on the 3 x 2 tiles of LW x LH: one gaussian per
    entry, in stream order tile by tile (flatten ids 0..n-1, zero ids in
    the padding); and the tile capacity."""
    if name in BWD_LAYOUTS:
        tiles, tc = _bwd_layout(name, rng)
        ent, offsets, L = _layout_stream(tiles)
        return _layout_args_packed(ent, offsets, L, D, rng), tc
    n = 96
    tile = rng.integers(0, 6, n)
    ox, oy = 16.0 * (tile % 3), 16.0 * (tile // 3)
    # a pixel centre of the tile, and a gaussian near it
    px = ox + rng.integers(0, 16, n) + 0.5
    py = oy + rng.integers(0, 16, n) + 0.5
    mean = np.stack([px, py], -1) + rng.uniform(-0.5, 0.5, (n, 2))
    size = rng.uniform(0.5, 3.0, n)
    th = rng.uniform(0, np.pi, n)
    stretch = np.ones((n, 2))
    op = rng.uniform(0.05, 0.95, n)
    if name == "means_inside_one_warp":
        # small, faint gaussians on pixel rows 2-3 of their tile: one warp
        # of the tile sees them
        mean[:, 1] = oy + rng.uniform(2.0, 4.0, n)
        size = rng.uniform(0.2, 0.6, n)
    elif name == "grazing_the_threshold":
        # isotropic, alpha within 0.1% of 1/255 at the pixel centre nearest
        # the mean, 1-3 pixels off a warp's rows
        mean[:, 1] = oy + 2.0 * rng.integers(0, 8, n) - rng.uniform(1.0, 3.0, n)
        near_y = np.clip(np.floor(mean[:, 1]) + 0.5, oy + 0.5, oy + 15.5)
        sigma = rng.uniform(1.0, 4.0, n)
        dist = np.abs(mean[:, 1] - near_y)
        size = dist / np.sqrt(2 * sigma)
        mean[:, 0] = px
        op = np.minimum(np.exp(sigma) / 255 * rng.uniform(0.999, 1.001, n), 1.0)
    elif name == "op_at_1_255":
        # op = 1/255 on a pixel centre (alpha = 1/255 there: included), just
        # above it, and up to 3 times it
        op[0::3] = np.float32(1 / 255)
        mean[0::3] = np.stack([px, py], -1)[0::3]
        op[1::3] = np.nextafter(np.float32(1 / 255), np.float32(1))
        op[2::3] = rng.uniform(1.0, 3.0, len(op[2::3])) / 255
        size = rng.uniform(2.0, 8.0, n)
    elif name == "scales_1e-4_against_1":
        stretch = np.stack([np.full(n, 1e-4), np.ones(n)], -1)
        size = rng.uniform(1.0, 20.0, n)
    order = np.argsort(tile, kind="stable")
    mean, size, th, stretch, op, tile = (x[order] for x in (mean, size, th, stretch, op, tile))
    conics = np.zeros((1, n, 3), np.float32)
    for i in range(n):
        R = np.array([[np.cos(th[i]), -np.sin(th[i])], [np.sin(th[i]), np.cos(th[i])]])
        inv = R @ np.diag(1.0 / (size[i] * stretch[i]) ** 2) @ R.T
        conics[0, i] = [inv[0, 0], inv[0, 1], inv[1, 1]]
    if name == "nan_rows":  # the first entry of tiles 0, 2 and 4
        first = np.searchsorted(tile, [0, 2, 4])
        conics[0, first, 1] = np.nan
    offsets = np.searchsorted(tile, np.arange(7)).astype(np.int32)
    L = n + 37
    ids = np.zeros(L, np.int32)
    ids[:n] = np.arange(n)
    return (torch.from_numpy(mean[None].astype(np.float32)), torch.from_numpy(conics),
            torch.from_numpy(rng.uniform(0, 1, (1, n, D)).astype(np.float32)),
            torch.from_numpy(op[None].astype(np.float32)), LW, LH, 16,
            torch.from_numpy(offsets), torch.from_numpy(ids)), 1024


@pytest.mark.cuda
@pytest.mark.parametrize("layout", CULL_LAYOUTS_K1)
def test_kernel_1_cull_layouts_on_card(cuda_device, layout):
    """Kernel 1 on tiles of few, many, cut and dead entries and on entries
    that graze its cull (conic_cull.cuh): within ATOL of the plain version,
    bitwise repeatable and independent of the split. A NaN conic makes
    sigma NaN, which the kernel includes at alpha = 0.999: every pixel of
    a tile that starts with one ends with T = 0.001 or less, so no warp
    culled it (the plain version cuts such tiles off at the NaN and is not
    held there)."""
    rng = np.random.default_rng(70 + CULL_LAYOUTS_K1.index(layout))
    args, tc = _k1_cull_layout(layout, rng)
    args = tuple(a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in args)
    bg = torch.tensor([[0.2, 0.5, 0.8]], device=cuda_device)
    tiles = None
    if layout == "nan_rows":
        ty, tx = torch.meshgrid(torch.arange(LH) // 16, torch.arange(LW) // 16, indexing="ij")
        nan_tile = ((ty * 3 + tx) % 2 == 0).to(cuda_device)  # tiles 0, 2 and 4
        tiles = ~nan_tile[None]
    _, train = _assert_k1(args, tc, bg, tiles)
    if layout == "nan_rows":
        assert bool(nan_tile.any())
        assert float(train[1][0][nan_tile].max()) <= 1.001e-3


def _eval3d_stream_tiles(seed, D, n_images, rolling_shutter, tile_size, N=300):
    """``_eval3d_stream`` at any tile size: (rows, d, o', offsets)."""
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
    tw, th = -(-W // tile_size), -(-H // tile_size)
    isect = isect_tiles_packed(means2d, radii, depths, tile_size, tw, th,
                               max_tiles_per_gauss=16 * (16 // tile_size) ** 2)
    rs = {}
    if rolling_shutter:
        end = t["viewmats"].clone()
        end[:, 0, 3] += 0.15
        rs = dict(rolling_shutter=RollingShutterType.TOP_TO_BOTTOM, viewmats_rs=end)
    d, o, o_ref = E.tile_rays_world(n_images, tw, th, tile_size, W, H, t["viewmats"], t["Ks"],
                                    **rs)
    colors = torch.from_numpy(rng.uniform(0, 1, size=(n_images, N, D)).astype(np.float32))
    opac = torch.from_numpy(rng.uniform(0.05, 0.95, size=(n_images, N)).astype(np.float32))
    feats = E.feature_rows(t["means"], t["quats"], t["scales"], opac, colors, o_ref)
    return (feats[isect.flatten_ids.long()].contiguous(), d.contiguous(),
            None if o is None else o.contiguous(), isect.offsets)


def _assert_k7(geo, tile_capacity, bg, keep=None):
    """Kernel 7's inference call (with ``bg``, if any) and training call: within
    ATOL of the plain version (on the pixels ``keep``, default all) and two
    launches bit for bit equal; returns the training call's outputs."""
    from tdgs_torch.ops import rasterize_eval3d_packed as E

    tc = tile_capacity
    I, D = geo[4], geo[5]
    img, alp = E.rasterize_eval3d_inference(*geo, bg, tc)
    img_t, T = E.rasterize_eval3d_train_fwd(*geo, tc)
    p_img, p_T, _ = E.rasterize_eval3d_fwd_plain(*geo, tc)
    torch.cuda.synchronize()
    keep = torch.ones_like(p_T, dtype=torch.bool) if keep is None else keep
    with_bg = p_img if bg is None else p_img + p_T[..., None] * bg.reshape(I, 1, 1, D)
    for g, w in ((img, with_bg), (alp[..., 0], 1.0 - p_T), (img_t, p_img), (T, p_T)):
        assert bool(torch.isfinite(g[keep]).all())
        torch.testing.assert_close(g[keep], w[keep], rtol=0, atol=ATOL)
    again = (E.rasterize_eval3d_inference(*geo, bg, tc), E.rasterize_eval3d_train_fwd(*geo, tc))
    assert torch.equal(again[0][0], img) and torch.equal(again[0][1], alp)
    assert torch.equal(again[1][0], img_t) and torch.equal(again[1][1], T)
    return img_t, T


@pytest.mark.cuda
# every templated channel bound (4, 8, 16, 32; D = 3 and 7 make rows of
# whole float4s: 16-byte copies), tiles of 16 and 8 pixels, one and two
# images, central and rolling-shutter cameras
@pytest.mark.parametrize("D,tile_size,n_images,rolling_shutter", [
    (1, 16, 1, False), (3, 8, 2, True), (3, 16, 1, False), (7, 16, 2, True),
    (8, 8, 1, False), (16, 16, 1, True), (32, 8, 2, False)])
def test_kernel_7_calls_on_card(cuda_device, D, tile_size, n_images, rolling_shutter):
    """Kernel 7's inference call with backgrounds and its training call,
    with and without the cut at tile_capacity = 128: within ATOL of the
    plain version and bitwise repeatable; rows that start off the 16-byte
    grid (4-byte copies) give the same bits as aligned ones."""
    dev = cuda_device
    rows, d, o, offsets = (None if x is None else x.to(dev) for x in
                           _eval3d_stream_tiles(400 + D, D, n_images, rolling_shutter,
                                                tile_size))
    assert int(torch.diff(offsets.long()).max()) > 128  # some tile is cut
    geo = (rows, d, o, offsets, n_images, D, W, H, tile_size)
    bg = torch.linspace(0.1, 0.9, D, device=dev).repeat(n_images, 1)
    for tc in (128, 1024):
        img, T = _assert_k7(geo, tc, bg)
    assert float(T.min()) < 0.5  # the gaussians cover pixels
    # the same rows one float past a 16-byte boundary
    buf = torch.empty(rows.numel() + 1, device=dev)
    shifted = buf[1:].view(rows.shape)
    shifted.copy_(rows)
    assert shifted.data_ptr() % 16 != 0
    from tdgs_torch.ops import rasterize_eval3d_packed as E

    got = E.rasterize_eval3d_train_fwd(shifted, *geo[1:], 1024)
    assert torch.equal(got[0], img) and torch.equal(got[1], T)


CULL_LAYOUTS_K7 = ["means_on_the_rays", "grazing_the_threshold",
                   "grazing_the_threshold_rolling_shutter", "op_at_1_255",
                   "scales_1e-4_against_1", "camera_inside_a_gaussian",
                   "entries_behind_the_camera", "nan_opacity_rows"]


def _k7_cull_layout(name, rng, n=64, D=3):
    """Kernel 7's operands on the 3 x 2 tiles of LW x LH (focal length 40,
    camera at the origin looking along +z): n world gaussians placed about
    the pixel rays, every tile walking all of them in one order."""
    from tdgs_torch.ops import rasterize_eval3d_packed as E
    from tdgs_torch.ops.camera_models import RollingShutterType

    viewmats = torch.eye(4)[None]
    Ks = torch.tensor([[[40.0, 0, LW / 2], [0, 40.0, LH / 2], [0, 0, 1]]])
    rs = {}
    if name.endswith("_rolling_shutter"):
        end = viewmats.clone()
        end[:, 0, 3] += 0.15
        rs = dict(rolling_shutter=RollingShutterType.TOP_TO_BOTTOM, viewmats_rs=end)
    d, o, o_ref = E.tile_rays_world(1, 3, 2, 16, LW, LH, viewmats, Ks, **rs)
    # a pixel ray each, a depth along it, a gaussian there
    ray = d.reshape(-1, 3)[torch.as_tensor(rng.integers(0, d.shape[0] * d.shape[1], n))]
    ray = ray.numpy().astype(np.float64)
    depth = rng.uniform(2.0, 6.0, (n, 1))
    side = np.cross(ray, [0.0, 1.0, 0.0])
    side /= np.linalg.norm(side, axis=-1, keepdims=True)
    up = np.cross(ray, side)
    off = rng.uniform(-1.5, 1.5, (n, 2)) / 40.0 * depth  # up to 1.5 pixels off
    means = depth * ray + off[:, :1] * side + off[:, 1:] * up
    scales = rng.uniform(0.02, 0.1, (n, 3))
    op = rng.uniform(0.05, 0.95, n)
    if name.startswith("grazing_the_threshold"):
        # spheres whose alpha = 1/255 surface passes within 10% of the
        # nearest ray, 1-3 pixels off it
        off = rng.uniform(1.0, 3.0, n) / 40.0 * depth[:, 0]
        means = depth * ray + off[:, None] * up
        s = off * rng.uniform(0.9, 1.1, n) / np.sqrt(2 * np.log(255 * op))
        scales = np.repeat(s[:, None], 3, axis=-1)
    elif name == "op_at_1_255":
        # op = 1/255, just above it, and up to 3 times it, on the rays
        means = depth * ray
        op[0::3] = np.float32(1 / 255)
        op[1::3] = np.nextafter(np.float32(1 / 255), np.float32(1))
        op[2::3] = rng.uniform(1.0, 3.0, len(op[2::3])) / 255
    elif name == "scales_1e-4_against_1":
        scales = np.where(rng.random((n, 3)) < 0.5, 1e-4, 1.0)
        scales[:, 0] = 1e-4
    elif name == "camera_inside_a_gaussian":
        means[: n // 4] = rng.uniform(-0.2, 0.2, (n // 4, 3))
        scales[: n // 4] = rng.uniform(0.5, 1.0, (n // 4, 3))
    elif name == "entries_behind_the_camera":
        means[::2] *= -1.0
    if name == "nan_opacity_rows":
        op[0] = np.nan  # the first entry, kept in tiles 0, 2 and 4 below
        means[0] = [0.0, 0.0, 4.0]
        scales[0] = [0.05, 0.05, 0.05]
    quats = rng.normal(size=(n, 4))
    t32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32))  # noqa: E731
    feats = E.feature_rows(t32(means), t32(quats), t32(scales), t32(op[None]),
                           t32(rng.uniform(0, 1, (1, n, D))), o_ref)
    T = d.shape[0]
    rows = feats.repeat(T, 1).contiguous()  # each tile walks all n entries
    if name == "nan_opacity_rows":
        rows[n::2 * n, 12] = 0.5  # tiles 1, 3 and 5: an opacity of 0.5
    offsets = torch.arange(T + 1, dtype=torch.int32) * n
    return rows, d.contiguous(), None if o is None else o.contiguous(), offsets


@pytest.mark.cuda
@pytest.mark.parametrize("layout", CULL_LAYOUTS_K7)
def test_kernel_7_cull_layouts_on_card(cuda_device, layout):
    """Kernel 7 on world gaussians that graze its cull (ray_cull.cuh): means
    on the pixel rays, spheres whose threshold surface passes within 10% of
    a ray, op at 1/255, scales 1e-4 against 1, a camera inside a gaussian,
    entries behind the camera: within ATOL of the plain version and bitwise
    repeatable. A NaN opacity makes alpha 0.999 wherever g.r < 0: every
    pixel of a tile that starts with one ends with T = 0.001 or less, so no
    warp culled the entry (the plain version cuts such tiles off at the NaN
    and is not held there)."""
    dev = cuda_device
    rng = np.random.default_rng(80 + CULL_LAYOUTS_K7.index(layout))
    rows, d, o, offsets = (None if x is None else x.to(dev)
                           for x in _k7_cull_layout(layout, rng))
    geo = (rows, d, o, offsets, 1, 3, LW, LH, 16)
    bg = torch.tensor([[0.2, 0.5, 0.8]], device=dev)
    nan_op = layout == "nan_opacity_rows"
    keep = None
    if nan_op:
        ty, tx = torch.meshgrid(torch.arange(LH) // 16, torch.arange(LW) // 16, indexing="ij")
        keep = ((ty * 3 + tx) % 2 == 1).to(dev)[None]  # tiles 1, 3 and 5
    img, T = _assert_k7(geo, 1024, bg, keep)
    if nan_op:
        assert float(T[~keep].max()) <= 1.001e-3
    else:
        assert float(T.min()) < 0.99  # the gaussians reach pixels


# ---------------------------------------------------------------------------
# Kernels 4 and 5: the contract of each call, and the per-warp surfel cull
# (surfel_cull.cuh, shared with kernel 6) on layouts that graze it
# ---------------------------------------------------------------------------


def _assert_k45(R, geo, feats, ids, tile_capacity, bg, mask=None):
    """Kernel 4 through flatten_ids (with ``bg``, if any) and kernel 5 (RGB+ED with
    the distortion): within ATOL of the plain version (on the pixels of
    ``mask``, default all), the distortion within 1e-3 of its scale, the
    median in all but 1% of the pixels; two launches bit for bit equal;
    kernel 4 through flatten_ids bitwise equal to kernel 4 on the same rows
    gathered into stream order; the output bitwise independent of the
    blocks each tile is cut into."""
    D, tc, ts = geo[3], tile_capacity, geo[6]
    k4 = (feats, ids) + geo[1:]
    before = {k: _build.LAUNCHES.get(k, 0) for k in (R.KERNEL_FWD, R.KERNEL_TRAIN)}
    got = R.rasterize_2dgs_inference(*k4, bg, tc)
    train = R.rasterize_2dgs_train_fwd(*geo, tc, D - 1, True)
    assert all(_build.LAUNCHES[k] == before[k] + 1 for k in before)
    p_img, p_nrm, p_T, p_dist, p_med, _ = R.rasterize_2dgs_fwd_plain(*geo, tc, D - 1, True)
    with_bg = p_img if bg is None else p_img + p_T[..., None] * bg[:, None, None, :]
    want = (with_bg, (1.0 - p_T)[..., None], p_nrm)
    torch.cuda.synchronize()
    m = torch.ones(p_T.shape, dtype=torch.bool, device=p_T.device) if mask is None else mask
    for g, w in list(zip(got, want)) + [(train[0], p_img), (train[1], p_nrm), (train[2], p_T)]:
        assert g.shape == w.shape
        assert bool(torch.isfinite(g[m]).all())
        torch.testing.assert_close(g[m], w[m], rtol=0, atol=ATOL)
    assert _rel_err(train[3][m], p_dist[m]) <= 1e-3
    assert _median_share(train[4][m], p_med[m]) <= 0.01

    again = R.rasterize_2dgs_inference(*k4, bg, tc)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    again = R.rasterize_2dgs_train_fwd(*geo, tc, D - 1, True)
    assert all(torch.equal(a, b) for a, b in zip(train, again))
    identity = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    gathered = R.rasterize_2dgs_inference(feats[ids.long()], identity, *geo[1:], bg, tc)
    assert all(torch.equal(a, b) for a, b in zip(got, gathered))
    warps = ts * ts // 32
    for n in [d for d in (1, 2, 4, 8) if warps % d == 0]:
        split = R.rasterize_2dgs_inference(*k4, bg, tc, n_split=n)
        assert all(torch.equal(a, b) for a, b in zip(got, split)), n
        split = R.rasterize_2dgs_train_fwd(*geo, tc, D - 1, True, n_split=n)
        assert all(torch.equal(a, b) for a, b in zip(train, split)), n
    return got, train


@pytest.mark.cuda
# every templated channel bound (DA <= 8, 16, 35), tiles of 16 and 8
# pixels, one and two images
@pytest.mark.parametrize("D,tile_size,n_images", [(1, 16, 1), (4, 16, 2), (4, 8, 1),
                                                  (10, 16, 1), (16, 8, 2), (32, 16, 1)])
def test_kernels_4_5_calls_on_card(cuda_device, D, tile_size, n_images):
    """Kernels 4 and 5 with and without the cut at tile_capacity = 128:
    within ATOL of the plain version, bitwise repeatable, kernel 4 through
    flatten_ids bitwise equal to it on gathered rows, and independent of
    the split."""
    from tdgs_torch.ops import rasterize_2dgs_packed as R

    s = _surfel_stream(400 + D, D, n_images, tile_size=tile_size)
    geo = (s["rows"].to(cuda_device), s["offsets"].to(cuda_device), n_images, D, W, H,
           tile_size)
    feats, ids = s["feats"].to(cuda_device), s["flatten_ids"].to(cuda_device)
    assert int(torch.diff(s["offsets"].long()).max()) > 128  # some tile is cut
    bg = torch.linspace(0.1, 0.9, D, device=cuda_device).repeat(n_images, 1)
    for tc in (128, 1024):
        got, _ = _assert_k45(R, geo, feats, ids, tc, bg)
    assert float(got[1].max()) > 0.5  # the surfels cover pixels


CULL_LAYOUTS_2DGS = BWD_LAYOUTS + ["edge_on_tmpz_changes_sign", "tmpz_below_1e-9",
                                   "op_at_1_255", "far_larger_than_the_tile",
                                   "grazing_the_threshold", "nan_geometry"]


def _cull_rows_2dgs(name, rng, D):
    """Surfel rows [L, 12 + D + 3] on the 3 x 2 tiles of LW x LH, in stream
    order tile by tile, with the offsets, the tile capacity and the tiles
    whose first entry has NaN geometry."""
    if name in BWD_LAYOUTS:
        tiles, tc = _bwd_layout(name, rng)
        ent, offsets, L = _layout_stream(tiles)
        return _layout_rows_2dgs(ent, L, D, rng), offsets, tc, []
    n = 96
    tile = np.sort(rng.integers(0, 6, n))
    ox, oy = 16.0 * (tile % 3), 16.0 * (tile // 3)
    px = ox + rng.integers(0, 16, n) + 0.5  # a pixel centre of the tile
    py = oy + rng.integers(0, 16, n) + 0.5
    c = np.stack([px, py], -1) + rng.uniform(-0.5, 0.5, (n, 2))
    size = rng.uniform(0.8, 4.0, n)
    op = rng.uniform(0.05, 0.95, n)
    if name == "op_at_1_255":
        # op = 1/255 on a pixel centre (alpha = 1/255 there: included), just
        # above it, and up to 3 times it
        op[0::3] = np.float32(1 / 255)
        c[0::3] = np.stack([px, py], -1)[0::3]
        op[1::3] = np.nextafter(np.float32(1 / 255), np.float32(1))
        op[2::3] = rng.uniform(1.0, 3.0, len(op[2::3])) / 255
        size = rng.uniform(2.0, 8.0, n)
    elif name == "far_larger_than_the_tile":
        c = c + rng.uniform(-150, 150, (n, 2))
        size = rng.uniform(30.0, 400.0, n)
        op = rng.uniform(0.02, 0.2, n)
    elif name == "grazing_the_threshold":
        # round, facing the camera, alpha within 0.1% of 1/255 at the pixel
        # centre nearest the centre, 1-3 pixels off a warp's rows
        c[:, 1] = oy + 2.0 * rng.integers(0, 8, n) - rng.uniform(1.0, 3.0, n)
        c[:, 0] = px
        near_y = np.clip(np.floor(c[:, 1]) + 0.5, oy + 0.5, oy + 15.5)
        sigma = rng.uniform(1.0, 4.0, n)
        size = np.maximum(np.abs(c[:, 1] - near_y) / np.sqrt(2 * sigma), 0.75)
        sigma = (c[:, 1] - near_y) ** 2 / (2 * size ** 2)
        op = np.minimum(np.exp(sigma) / 255 * rng.uniform(0.999, 1.001, n), 1.0)
    L = n + 37
    rows = rng.normal(size=(L, 12 + D + 3)).astype(np.float32)
    for i in range(n):
        th = rng.uniform(0, np.pi)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        stretch = [1.0, 1.0] if name == "grazing_the_threshold" else rng.uniform(0.7, 1.4, 2)
        A = rot @ np.diag(stretch) / size[i]
        M = np.zeros((3, 3))
        M[:2, :2] = A
        M[:2, 2] = -A @ c[i]
        M[2] = [0.0, 0.0, 1.0]
        if name != "grazing_the_threshold":
            tilt = rng.uniform(-0.01, 0.01, 2)
            M[2] = [tilt[0], tilt[1], 1.0 - tilt @ c[i]]
        if name == "edge_on_tmpz_changes_sign":
            # tmpz = s (n . (p - c) + e), zero on a line within 2 pixels of
            # the centre
            phi, s, e = rng.uniform(0, 2 * np.pi), rng.uniform(0.05, 1.0), rng.uniform(-2, 2)
            nrm = np.array([np.cos(phi), np.sin(phi)])
            M[2] = s * np.array([nrm[0], nrm[1], e - nrm @ c[i]])
        elif name == "tmpz_below_1e-9":
            # |tmpz| < 1e-9 over the tile: constant, or crossing zero
            M[2] = [0.0, 0.0, 3e-10] if i % 2 else [1e-11, 0.0, -1e-11 * c[i, 0]]
        rows[i, :12] = [c[i, 0], c[i, 1], *M[:, 2], *M[:, 0], *M[:, 1], op[i]]
        rows[i, 12:] = rng.uniform(0, 1, D + 3)
    rows[:n, 12 + D - 1] = rng.uniform(1, 10, n)  # the depth channel
    nan_tiles = []
    if name == "nan_geometry":  # the first entry of tiles 0, 2 and 4
        nan_tiles = [0, 2, 4]
        rows[np.searchsorted(tile, nan_tiles), :12] = np.nan
    offsets = np.searchsorted(tile, np.arange(7)).astype(np.int32)
    return torch.from_numpy(rows), torch.from_numpy(offsets), 1024, nan_tiles


@pytest.mark.cuda
@pytest.mark.parametrize("layout", CULL_LAYOUTS_2DGS)
def test_kernels_4_5_cull_layouts_on_card(cuda_device, layout):
    """Kernels 4 and 5 (RGB+ED, D = 4) on tiles of few, many, cut and dead
    entries and on surfels that graze their cull: within ATOL of the plain
    version, bitwise repeatable, through flatten_ids as on gathered rows,
    independent of the split. NaN geometry makes sigma NaN, which the
    kernels include at alpha = 0.999: every pixel of a tile that starts with
    one ends with T = 0.001 or less, so no warp culled it (the plain version
    skips such entries and is not held there)."""
    from tdgs_torch.ops import rasterize_2dgs_packed as R

    D = 4
    rng = np.random.default_rng(90 + CULL_LAYOUTS_2DGS.index(layout))
    rows, offsets, tc, nan_tiles = _cull_rows_2dgs(layout, rng, D)
    geo = (rows.to(cuda_device), offsets.to(cuda_device), 1, D, LW, LH, 16)
    F = 12 + D + 3
    feats = torch.nn.functional.pad(geo[0], (0, R.padded_width(D) - F)).contiguous()
    ids = torch.arange(rows.shape[0], dtype=torch.int32, device=cuda_device)
    bg = torch.tensor([[0.2, 0.5, 0.8, 0.0]], device=cuda_device)
    ty, tx = torch.meshgrid(torch.arange(LH) // 16, torch.arange(LW) // 16, indexing="ij")
    nan_tile = torch.isin(ty * 3 + tx, torch.tensor(nan_tiles, dtype=torch.long))
    nan_tile = nan_tile.to(cuda_device)[None]
    _, train = _assert_k45(R, geo, feats, ids, tc, bg, ~nan_tile)
    if nan_tiles:
        assert bool(nan_tile.any())
        assert float(train[2][nan_tile].max()) <= 1.001e-3


# ---------------------------------------------------------------------------
# Kernels 1 (training call) and 2 at the depth path's D = 4 ("RGB+ED"): the
# fourth channel is the expected depth, live, with its own cotangent
# ---------------------------------------------------------------------------

DEPTH_LAYOUTS = ["few_entries", "many_entries", "cut_entries", "dead_entries"]


def _depth_layout_args(name, tile_size, rng):
    """Kernel 1 and 2's operands at D = 4 on the LW x LH frame cut into
    tiles of ``tile_size``: one gaussian per entry, in stream order tile by
    tile; colours in [0, 1] and a depth channel in [1, 10]. Returns (args,
    tile capacity)."""
    tw, th = LW // tile_size, LH // tile_size
    s = tile_size / 16.0

    def entries(t, n, size=(1.0, 6.0), op=(0.05, 0.95)):
        ox, oy = tile_size * (t % tw), tile_size * (t // tw)
        return np.stack([ox + rng.uniform(-4 * s, 20 * s, n), oy + rng.uniform(-4 * s, 20 * s, n),
                         s * rng.uniform(*size, n), rng.uniform(*op, n)], -1)

    tc = 1024
    if name == "few_entries":  # 0, 1, 2 or 3 a tile
        tiles = [entries(t, t % 4) for t in range(tw * th)]
    elif name == "many_entries":
        tiles = [entries(t, 150) for t in range(tw * th)]
    elif name == "cut_entries":  # 300 faint entries cut at 128
        tiles = [entries(t, 300 if t == 1 else 12, op=(0.02, 0.1)) for t in range(tw * th)]
        tc = 128
    elif name == "dead_entries":
        # small faint entries on the first pixel row of tile 1: the warps of
        # the other rows walk them all and include none
        tiles = [np.zeros((0, 4))] * (tw * th)
        e = entries(1, 40, size=(0.2, 0.3), op=(0.05, 0.15))
        e[:, 1] = 0.5
        tiles[1] = e
        tiles[3] = entries(3, 5)
    else:
        raise ValueError(name)
    ent, offsets, L = _layout_stream(tiles)
    args = list(_layout_args_packed(ent, offsets, L, 4, rng))
    args[2][..., 3] = torch.from_numpy(rng.uniform(1, 10, len(ent)).astype(np.float32))
    args[6] = tile_size
    return tuple(args), tc


@pytest.mark.cuda
# D = 4 at 16-pixel tiles is kernel 2's HALF_ROWS build (4 + D = 8 values a
# half-warp, each half-warp one pixel row); at 8-pixel tiles its CMAX = 4
# build over whole warps
@pytest.mark.parametrize("tile_size", [16, 8])
@pytest.mark.parametrize("layout", DEPTH_LAYOUTS)
def test_kernels_1_2_at_the_depth_path_d4_on_card(cuda_device, layout, tile_size):
    """Kernel 1's training call and kernel 2 on "RGB+ED" rows (D = 4, the
    fourth channel a depth in [1, 10] with its own random cotangent), on
    tiles of few, many, cut and dead entries: the forward within ATOL, each
    gradient group and the depth column within 1e-3 of the plain version,
    kernel 2 bitwise repeatable, the padding zero."""
    rng = np.random.default_rng(400 + 10 * DEPTH_LAYOUTS.index(layout) + tile_size)
    args, tc = _depth_layout_args(layout, tile_size, rng)
    args = tuple(a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in args)
    img, trans = rasterize_packed_train_fwd(*args, tile_capacity=tc)
    img_p, trans_p = rasterize_packed_train_fwd_plain(*args, tile_capacity=tc)
    torch.testing.assert_close(img, img_p, rtol=0, atol=ATOL)
    torch.testing.assert_close(trans, trans_p, rtol=0, atol=ATOL)
    if layout != "dead_entries":
        assert float(img[..., 3].max()) > 1.0  # the depth lane is live
    first, second, want = _bwd_packed(args, tc, 500 + tile_size)
    _assert_rows(first, second, want, dict(GROUPS, depth=slice(9, 10)),
                 int(args[7][-1]))
    if layout != "dead_entries":
        assert float(first[:, 9].abs().max()) > 0
    if layout == "cut_entries":
        start = int(args[7][1])
        assert float(first[start + 128:start + 300].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the sharded path on the card: worlds of 2 (and 4, the 2-D mesh) ranks
# sharing one card over gloo, each case against the single-rank render of
# each rank's cameras (parallel.checks), kernels 1-10 through the exchange
# ---------------------------------------------------------------------------

SHARDED_CASES = dict(checks.RENDER_CASES, **checks.MESH2D_CASES)


@pytest.fixture(scope="module")
def sharded_results():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    names = sorted(checks.RENDER_CASES)
    res = launch.run(checks.render_cases, 2, names, None, "cuda", device="cuda",
                     timeout_s=600)
    out = {n: [r[n] for r in res] for n in names}
    res4 = launch.run(checks.render_cases, 4, ["mesh2d"], (2, 2), "cuda", device="cuda",
                      timeout_s=600)
    out["mesh2d"] = [r["mesh2d"] for r in res4]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_render_matches_single_rank_on_card(sharded_results, case):
    """Each rank's sharded render (outputs and the gradients of every
    gaussian input, summed over the ranks) against the single-rank render of
    its cameras: ATOL on outputs (the ED channel relatively where alpha >
    0.1), 1e-3 of the largest gradient per input."""
    for r, res in enumerate(sharded_results[case]):
        for k in ("img", "alpha", "normals", "distort"):
            if f"single_{k}" not in res:
                continue
            got, want = res[k], res[f"single_{k}"]
            assert np.isfinite(got).all(), (case, r, k)
            if k == "img" and SHARDED_CASES[case]["render_mode"].endswith("ED"):
                seen = res["single_alpha"][..., 0] > 0.1
                np.testing.assert_allclose(got[..., -1][seen], want[..., -1][seen], rtol=2e-3)
                got, want = got[..., :-1], want[..., :-1]
            np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"{case}/{r}/{k}")
        for k in res:
            if k.startswith("single_grad_"):
                g, w = res[k[len("single_"):]], res[k]
                scale = max(float(np.abs(w).max()), 1e-30)
                assert float(np.abs(g - w).max()) <= 1e-3 * scale, (case, r, k)


# ---------------------------------------------------------------------------
# the viewer: each family's frame (kernels 1, 4, 7) against the plain route
# on the card, kernel 4 against the float64 surfel golden, and the live view
# of a training Runner
# ---------------------------------------------------------------------------

VIEWER_FAMILIES = ("3dgs", "2dgs", "3dgut")


def _viewer_splats(seed=5, n=400):
    rng = np.random.default_rng(seed)
    return {
        "means": (rng.normal(size=(n, 3)) * [1.0, 0.7, 0.5]).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "scales": np.log(rng.uniform(0.03, 0.15, size=(n, 3))).astype(np.float32),
        "opacities": rng.normal(0.5, 1.0, size=(n,)).astype(np.float32),
        "sh0": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "shN": (rng.normal(size=(n, 15, 3)) * 0.2).astype(np.float32),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("family", VIEWER_FAMILIES)
@pytest.mark.parametrize("mode", ["rgb", "depth", "alpha"])
def test_viewer_frame_matches_plain_route_on_card(cuda_device, family, mode):
    """``make_splat_render_fn``'s frame through the family's kernel against
    the same render through the plain tensor route, on the card: uint8
    within 1 level (depth: of the same percentile scaling)."""
    from tdgs_torch.viewer import server as V

    raw = _viewer_splats()
    vm = V.orbit_camera(0.5, 0.35, 4.0, np.zeros(3, np.float32))
    K = np.array([[120.0, 0, 64], [0, 120.0, 40], [0, 0, 1]], np.float32)
    st = V.RenderTabState(render_mode=mode, backgrounds=(0.1, 0.2, 0.3))
    _build.reset_launches()
    got = V.make_splat_render_fn(raw, model_type=family, device="cuda")(vm, K, 128, 80, st)
    kernel = {"3dgs": KERNEL, "2dgs": "rasterize_2dgs_fwd", "3dgut": "rasterize_eval3d_fwd"}
    assert _build.LAUNCHES.get(kernel[family], 0) == 1
    plain = "eval3d" if family == "3dgut" else "jax"
    want = V.make_splat_render_fn(raw, rasterizer=plain, model_type=family,
                                  device="cuda")(vm, K, 128, 80, st)
    assert want.max() > 0
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, (family, mode, diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["viewer_rgb", "viewer_rgb_depth", "bench_1080p"])
def test_golden_2dgs_against_kernel_4_on_card(cuda_device, request, case):
    """Kernel 4's frame against ``compose_reference_2dgs_f64`` over the same
    stream (M's columns), a tile capacity that keeps every entry of the
    fullest tile, colours and alpha: the viewer's splats at 128x80 in "RGB"
    and "RGB+D" within 1e-3 absolute; the bench scene at 1080p in "RGB" at
    40 dB or more, as the chain's ``kernel_vs_oracle_psnr`` is held (there
    float32 and float64 end a few pixels' walks at different entries: 140
    of its 6.2M values lie up to 0.0103 apart)."""
    from tdgs_torch.rendering import _colors_per_camera, rasterization_2dgs
    from tdgs_torch.utils.golden import compose_reference_2dgs_f64

    dev, tc = torch.device("cuda"), 4096
    if case == "bench_1080p":
        sc = request.getfixturevalue("scenes")["bench"]
        splats = tuple(sc[k] for k in ("means", "quats", "scales", "opacities", "sh"))
        vm, K, width, height = sc["viewmats"], sc["Ks"], C.WIDTH, C.HEIGHT
        kw = dict(max_tiles_per_gauss=16)
    else:
        t = {k: torch.as_tensor(v, device=dev) for k, v in _viewer_splats(seed=6).items()}
        splats = (t["means"], t["quats"], torch.exp(t["scales"]), torch.sigmoid(t["opacities"]),
                  torch.cat([t["sh0"], t["shN"]], 1))
        vm = torch.eye(4, device=dev)[None]
        vm[0, 2, 3] = 4.0
        K = torch.tensor([[[120.0, 0, 64], [0, 120.0, 40], [0, 0, 1]]], device=dev)
        width, height, kw = 128, 80, {}
    with_depth = case == "viewer_rgb_depth"
    with torch.no_grad():
        out = rasterization_2dgs(*splats, vm, K, width, height, sh_degree=3,
                                 render_mode="RGB+D" if with_depth else "RGB", tile_capacity=tc,
                                 rasterizer="packed_inference", device=dev, **kw)
        meta = out[6]
        cols = _colors_per_camera(splats[4], 3, splats[0], vm, meta["radii"])
    if with_depth:
        cols = torch.cat([cols, meta["depths"][..., None]], -1)
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    offsets = host(meta["isect_offsets"])
    assert int(np.diff(offsets).max()) <= tc
    img, alpha = compose_reference_2dgs_f64(
        offsets, host(meta["flatten_ids"]), host(meta["means2d"]).reshape(-1, 2),
        host(meta["ray_transforms"]).reshape(-1, 3, 3), host(cols).reshape(-1, cols.shape[-1]),
        host(meta["opacities"]).reshape(-1), width, height, 16, meta["tile_width"],
        meta["tile_height"], n_isects=int(meta["n_isects"]))
    assert alpha.max() > 0.5
    if case == "bench_1080p":
        from tdgs_torch.rally_e2e import psnr_np

        assert psnr_np(np.clip(host(out[0][0]), 0, 1), np.clip(img, 0, 1)) >= 40.0
        assert psnr_np(host(out[1][0, ..., 0]), alpha) >= 40.0
        return
    np.testing.assert_allclose(host(out[0][0]), img, atol=ATOL)
    np.testing.assert_allclose(host(out[1][0, ..., 0]), alpha, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["3dgs", "2dgs"])
def test_live_view_during_training_on_card(cuda_device, model_type, tmp_path):
    """A Runner with the live viewer on serves JPEG frames (kernel 1 or 4)
    while it trains, under the lock, with no 500; the loss drops."""
    import threading
    import urllib.request

    from tdgs_torch.training.config import Config
    from tdgs_torch.training.trainer import Runner
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    make_colmap_test_scene(str(tmp_path / "scene"), device="cuda")
    extra = dict(normal_loss=True, dist_loss=True) if model_type == "2dgs" else {}
    cfg = Config(data_dir=str(tmp_path / "scene"), result_dir=str(tmp_path / "r"),
                 data_factor=1, max_steps=60, eval_steps=[], save_steps=[], ply_steps=[],
                 sh_degree=1, sh_degree_interval=20, capacity=512, tile_capacity=256,
                 test_every=4, tb_every=20, disable_viewer=False, viewer_port=0,
                 model_type=model_type, **extra)
    runner = Runner(cfg, device="cuda")
    frames, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            url = f"http://127.0.0.1:{runner.viewer.port}/render?w=64&h=48&dist=3"
            with urllib.request.urlopen(url, timeout=60) as r:
                frames.append((r.status, r.read(2)))

    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        hist = runner.train()["history"]
        n_during = len(frames)
    finally:
        stop.set()
        th.join(timeout=60)
        runner.close()
    assert not th.is_alive()
    assert n_during > 0 and set(frames) == {(200, b"\xff\xd8")}
    assert hist[-1]["loss"] < hist[0]["loss"]


# ---------------------------------------------------------------------------
# every kernel at full size (tests/card_scenes.py): the 200k-gaussian 1080p
# bench scene at the shapes of its render and training paths, a scene whose
# tiles overflow tile_capacity 128, the rally's scene, the ortho and fisheye
# cameras; each held by the helpers that hold the small streams above
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scenes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return C.full_size_scenes()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(C.KERNEL_1_CASES))
def test_kernel_1_matches_plain_at_full_size_on_card(scenes, case):
    args, bg, tc = C.kernel_1_case(scenes, case)
    _assert_k1(args, tc, bg)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["a_bench", "b_heavy_overlap_truncated"])
def test_kernels_1_to_3_train_at_full_size_on_card(scenes, case):
    args, tc, seed = C.train_case(scenes, case)
    if tc == 128:
        counts = torch.diff(args[7].long())
        assert int((counts > max_entries_per_tile(tc)).sum()) > 0  # the cut is live
    _assert_k123(args, tc, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(C.KERNEL_2DGS_CASES))
def test_kernels_4_to_6_at_full_size_on_card(scenes, case):
    """Kernels 4 and 5 held as ``_assert_k45`` holds them, without and with
    a background; on "RGB+ED" with the distortion (the training path's)
    kernel 6 too, bit for bit repeatable, the gradient rows within BWD_RTOL
    per group."""
    geo, k4, tc, seed = C.kernel_2dgs_case(scenes, case)
    for bg in (None, C.background(geo[3])):
        _assert_k45(R2, geo, k4[0], k4[1], tc, bg)
    if case == "a_bench_rgb":  # the render path's: no backward
        return
    first, second, want = _bwd_2dgs(R2, geo, tc, seed)
    assert torch.equal(first, second) and bool(torch.isfinite(first).all())
    for name, cols in GROUPS_2DGS.items():
        assert _rel_err(first[:, cols], want[:, cols]) <= C.BWD_RTOL, name


EVAL3D_GROUPS = {"M": slice(0, 9), "g0": slice(9, 12), "opacity": slice(12, 13),
                 "colors": slice(13, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(C.KERNEL_EVAL3D_CASES))
def test_kernels_7_8_at_full_size_on_card(scenes, case):
    """Kernel 7 held as ``_assert_k7`` holds it, without and with a
    background; kernel 8's rows and ray gradients within BWD_RTOL per
    group."""
    geo, _, tc, seed = C.kernel_eval3d_case(scenes, case)
    stream = geo[:9]
    for bg in (None, C.background()):
        _assert_k7(stream, tc, bg)
    img, T, v_img, v_T = C.train_stream_eval3d(stream, tc, seed)
    got = E.rasterize_eval3d_bwd(*stream, img, T, v_img, v_T, tc)
    want = E.rasterize_eval3d_bwd_plain(*stream, img, T, v_img, v_T, tc)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in got if x is not None)
    rel = {k: _rel_err(got[0][:, c], want[0][:, c]) for k, c in EVAL3D_GROUPS.items()}
    rel["v_d"] = _rel_err(got[1], want[1])
    if stream[2] is not None:
        rel["v_o"] = _rel_err(got[2], want[2])
    assert max(rel.values()) <= C.BWD_RTOL, rel


@pytest.mark.cuda
def test_eval3d_sigma_matches_float64_at_full_size_on_card(scenes):
    """σ* of the eval3d walk in float32 (the plain version's arithmetic,
    which is the kernels' operation for operation) against σ* in float64
    from the same float32 scene, over every (pixel, entry) pair of the
    bench frame's cut ranges inside the image, in front of the camera,
    with σ* below 4: within SIGMA_TOL."""
    geo, extra, tc, _ = C.kernel_eval3d_case(scenes, "a_bench_rgb_central")
    sc = scenes["bench"]
    rows, d, o, offsets, I, D, W, H, ts = geo
    meta = extra["meta"]
    f64 = {k: sc[k].double() for k in ("means", "quats", "scales", "viewmats", "Ks")}
    d64, o64, o_ref64 = E.tile_rays_world(1, meta["tile_width"], meta["tile_height"], ts,
                                          W, H, f64["viewmats"], f64["Ks"], **extra["rs"])
    N = sc["means"].shape[0]
    feats64 = E.feature_rows(f64["means"], f64["quats"], f64["scales"],
                             meta["opacities"].reshape(1, N).double(),
                             torch.zeros((1, N, D), dtype=torch.float64, device="cuda"),
                             o_ref64)
    rows64 = feats64[meta["flatten_ids"].long()]
    r32, r64 = E._response_eval3d(rows, d, o), E._response_eval3d(rows64, d64, o64)
    counts = torch.clamp(torch.diff(offsets.long()), 0, max_entries_per_tile(tc))
    starts = offsets[:-1].long()
    tw, P, T = meta["tile_width"], ts * ts, counts.shape[0]
    p = torch.arange(P, device="cuda")
    chunk = max(1, (1 << 22) // (P * max(int(counts.max()), 1)))
    worst, pairs = 0.0, 0
    for t0 in range(0, T, chunk):
        tt = torch.arange(t0, min(t0 + chunk, T), device="cuda")
        L = int(counts[tt].max())
        if L == 0:
            continue
        lane = torch.arange(L, device="cuda")
        valid = lane[None, :] < counts[tt, None]
        idx = torch.where(valid, starts[tt, None] + lane[None, :], 0)
        s32 = r32(tt, idx, None, None, None)[0]
        s64 = r64(tt, idx, None, None, None)[0]
        px = (tt % tw * ts)[:, None] + p % ts
        py = (tt // tw * ts)[:, None] + p // ts
        inside = ((px < W) & (py < H))[:, :, None]
        sel = valid[:, None, :] & inside & (s64 >= 0) & (s64 < 4.0) & (s32 >= 0)
        err = (s32.double() - s64)[sel].abs()
        pairs += int(err.numel())
        if err.numel():
            worst = max(worst, float(err.max()))
    assert pairs > 0
    assert worst <= C.SIGMA_TOL, worst


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(C.KERNEL_DENSE_CASES))
def test_kernels_9_10_at_full_size_on_card(scenes, case):
    """Kernels 9 and 10 held as ``_assert_dense`` holds them, and kernel 9's
    outputs with the background blended as the wrapper blends it (where
    there is one) within TOL; the heavy case must cut a tile at its
    capacity of 128."""
    (rows, counts, geo, *_), bg, meta = C.kernel_dense_case(scenes, case)
    if case == "c_heavy_overlap_truncated":
        offs = meta["isect_offsets"].reshape(-1).long()
        ranges = torch.diff(torch.cat([offs, offs.new_tensor([meta["n_isects"]])]))
        assert int((ranges > 128).sum()) > 0
    fwd, fwd_p, bwd, bwd_p, _ = _dense_both(RP, rows, counts, geo, C.KERNEL_DENSE_CASES[case][2])
    _assert_dense(fwd, fwd_p, bwd, bwd_p, counts)
    if bg is not None:
        (img, trans), (img_p, trans_p) = fwd[0], fwd_p
        b = bg.reshape(1, 1, 1, -1)
        torch.testing.assert_close(img + trans[..., None] * b, img_p + trans_p[..., None] * b,
                                   rtol=0, atol=ATOL)


def _dense_window(counts_fn, max_bytes=1e9, size=(512, 288)):
    """The largest centred window of the bench view, halved from ``size``
    until the dense rasterizers' largest [tiles, pixels, capacity] tensor
    fits ``max_bytes`` (autograd keeps a few dozen of them), with the
    capacity the window's longest tile (whole 128s, so that the packed
    kernels cut nothing either): (W, H, tile_capacity, entries).
    ``counts_fn(W, H)`` gives the packed stream's entries a tile."""
    W, H = size
    while True:
        counts = counts_fn(W, H)
        cap = max(128, -(-int(counts.max()) // 128) * 128)
        if counts.numel() * 256 * cap * 4 <= max_bytes or W <= 64:
            return W, H, cap, int(counts.sum())
        W, H = W // 2, H // 2


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["eval3d", "2dgs"])
def test_dense_references_match_kernels_at_full_size_on_card(scenes, family):
    """The dense plain-tensor rasterizers, independent of the kernels, as
    references for them: on a centred window of the bench view sized from
    its stream (no tile cut), the dense ``"eval3d"`` against
    ``"eval3d_packed"`` (kernels 7, 8, 3), "RGB" with the gradients to every
    input and the pose, and the dense 2DGS ``"jax"`` against ``"packed"``
    (kernels 5, 6, 3) in "RGB+ED" with the distortion. Outputs within TOL
    (distortion DIST_RTOL, median MEDIAN_SHARE), each input's gradient
    within BWD_RTOL of its max; neither side drops an entry."""
    sc = scenes["bench"]

    def window_Ks(W, H):
        Ks = sc["Ks"].clone()
        Ks[:, 0, 2], Ks[:, 1, 2] = W / 2, H / 2
        return Ks

    def counts(W, H):
        with torch.no_grad():
            if family == "eval3d":
                meta = tdgs_torch.rasterization(
                    sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
                    sc["viewmats"], window_Ks(W, H), W, H, sh_degree=3,
                    rasterizer="packed_inference", device="cuda")[2]
            else:
                meta = tdgs_torch.rasterization_2dgs(
                    sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
                    sc["viewmats"], window_Ks(W, H), W, H, sh_degree=3,
                    rasterizer="packed_inference", device="cuda")[-1]
        return torch.diff(meta["isect_offsets"].long())

    W, H, cap, entries = _dense_window(counts)
    Ks = window_Ks(W, H)
    kw = dict(sh_degree=3, tile_capacity=cap, device="cuda",
              isect_capacity=1 << (max(entries, 1) * 2 - 1).bit_length())
    names = ("means", "quats", "scales", "opacities", "sh")
    dropped = {}
    if family == "eval3d":
        names += ("viewmats",)

        def render(route, *x):
            img, alp, meta = tdgs_torch.rasterization(
                *x[:5], x[5], Ks, W, H, with_eval3d=True,
                rasterizer="eval3d" if route == "dense" else "eval3d_packed", **kw)
            dropped[route] = int(meta["n_dropped"])
            return img, alp
        n_out = 2
    else:
        def render(route, *x):
            out = tdgs_torch.rasterization_2dgs(
                *x, sc["viewmats"], Ks, W, H, render_mode="RGB+ED", distloss=True,
                rasterizer="jax" if route == "dense" else "packed", **kw)
            dropped[route] = int(out[-1]["n_dropped"])
            return out[0], out[1], out[2], out[4], out[5]
        n_out = 4  # colours, alpha, normals, distortion (the median has no gradient)
    gen = torch.Generator(device="cuda").manual_seed(13)
    res, cot = {}, None
    for route in ("dense", "kernel"):
        leaves = [sc[k].detach().clone().requires_grad_(True) for k in names]
        out = render(route, *leaves)
        if cot is None:
            cot = [torch.randn(o.shape, generator=gen, device="cuda") for o in out[:n_out]]
        grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out[:n_out], cot)),
                                    leaves, allow_unused=True)
        res[route] = ([o.detach() for o in out], grads)
    (d_out, d_grads), (k_out, k_grads) = res["dense"], res["kernel"]
    assert not any(dropped.values()), dropped
    assert float(k_out[1].max()) >= 0.5
    for a, b in zip(d_out[:3], k_out[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
    if family == "2dgs":
        assert _rel_err(d_out[3], k_out[3]) <= C.DIST_RTOL
        assert float(((d_out[4] - k_out[4]).abs() > 1e-4).float().mean()) <= C.MEDIAN_SHARE
    for name, a, b in zip(names, d_grads, k_grads):
        assert _rel_err(a, b) <= C.BWD_RTOL, name
