"""The CUDA kernels against their plain PyTorch versions, on the card: the
compositing forward (kernel 1), its backward (kernel 2) and the sorted
segment sum (kernel 3).

The kernels have no CPU mode, so every test here is marked ``cuda`` and skips
without a card. The file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_card.py

Tolerances, as chip_smoke.py holds the kernels at full size: 1e-3 absolute
for the forward (the kernel accumulates colours in a running sum, the plain
version in a matrix product); max|Δ| / max|plain| ≤ 1e-3 per gradient group
for the backward (the kernel sums 256 pixels by shuffles, the plain version
with ``sum``); 1e-5 relative per column for the segment sum, whose two
launches must agree bit for bit.
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
