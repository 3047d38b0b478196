"""Port parity of the packed rasterizer's gradients: the plain versions of
kernel 2 (per-entry rows) and kernel 3 (segment sum) behind
``tdgs_torch.ops.rasterize_packed.rasterize_to_pixels_packed`` against
``jax.grad`` of the JAX package's ``rasterize_to_pixels_packed`` (Pallas in
interpret mode on the CPU), on the SAME stream: offsets and flatten_ids
come from the JAX package's tiling and are handed to both.

Tolerance: max|Δ| / max|ref| ≤ 1e-3 for each gradient. The JAX kernels
take the transmittance prefix in log space and split products into bf16
limbs; the port keeps a running product and plain float32 products.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops.rasterize_pallas_packed import (
    rasterize_to_pixels_packed as j_raster,
)
from tdgs_torch.ops import _build
from tdgs_torch.ops.rasterize_packed import (
    CHUNK,
    max_entries_per_tile,
    rasterize_packed_bwd_plain,
    rasterize_packed_train_fwd_plain,
    rasterize_to_pixels_packed,
    rasterize_to_pixels_packed_inference_plain,
)
from tdgs_torch.ops.segment_sum import segment_rows_sum_plain, sort_ids
from tdgs.ops import tiling as jtiling
from tdgs.ops.projection import fully_fused_projection
from tests.test_torch_rasterize_packed import _projected_stream, _raster_stream

RTOL = 1e-3
NAMES = ("means2d", "conics", "colors", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cotangents(seed, I, H, W, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(I, H, W, D)).astype(np.float32),
            rng.normal(size=(I, H, W, 1)).astype(np.float32))


def _jax_grads(s, colors, v_img, v_alp, bg, tile_capacity, abs_tap=False):
    G = s["means2d"].shape[0] * s["means2d"].shape[1]

    def loss(m2, con, col, op, dummy):
        img, alp = j_raster(
            m2, con, col, op, s["width"], s["height"], 16,
            jnp.asarray(s["offsets"]), jnp.asarray(s["flatten_ids"]),
            backgrounds=None if bg is None else jnp.asarray(bg),
            tile_capacity=tile_capacity,
            absgrad_dummy=dummy if abs_tap else None,
        )
        return jnp.sum(img * v_img) + jnp.sum(alp * v_alp)

    args = [jnp.asarray(s["means2d"]), jnp.asarray(s["conics"]),
            jnp.asarray(colors), jnp.asarray(s["opacities"]),
            jnp.zeros((G, 2), jnp.float32)]
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    return [np.asarray(g) for g in grads]


def _port_grads(s, colors, v_img, v_alp, bg, tile_capacity, abs_tap=False):
    G = s["means2d"].shape[0] * s["means2d"].shape[1]
    leaves = [torch.tensor(x, requires_grad=True) for x in
              (s["means2d"], s["conics"], colors, s["opacities"])]
    dummy = torch.zeros((G, 2), requires_grad=True) if abs_tap else None
    img, alp = rasterize_to_pixels_packed(
        *leaves, s["width"], s["height"], 16,
        torch.from_numpy(s["offsets"]), torch.from_numpy(s["flatten_ids"]),
        backgrounds=None if bg is None else torch.from_numpy(bg),
        tile_capacity=tile_capacity, absgrad_dummy=dummy,
    )
    loss = (img * torch.from_numpy(v_img)).sum() + (alp * torch.from_numpy(v_alp)).sum()
    loss.backward()
    out = [x.grad.numpy() for x in leaves]
    return out + ([dummy.grad.numpy()] if abs_tap else []), img, alp


def _assert_close(got, want, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0.0, name
    assert err <= RTOL * scale, f"{name}: max|Δ| {err} > {RTOL} · {scale}"


@pytest.mark.parametrize("D,with_bg", [(3, False), (4, True)])
def test_packed_grads_match_jax(D, with_bg):
    s = _projected_stream(410 + D)
    colors = s["colors"]
    if D == 4:  # RGB + depth, as render_mode "RGB+D"
        colors = np.concatenate([colors, s["depths"][..., None]], -1)
    bg = np.linspace(0.2, 0.8, D, dtype=np.float32)[None] if with_bg else None
    v_img, v_alp = _cotangents(7 + D, 1, s["height"], s["width"], D)
    want = _jax_grads(s, colors, v_img, v_alp, bg, 1024)
    got, img, alp = _port_grads(s, colors, v_img, v_alp, bg, 1024)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        _assert_close(g, w, name)
    # the training forward agrees with the inference forward
    ref_img, ref_alp = rasterize_to_pixels_packed_inference_plain(
        *[torch.from_numpy(x) for x in (s["means2d"], s["conics"], colors,
                                        s["opacities"])],
        s["width"], s["height"], 16, torch.from_numpy(s["offsets"]),
        torch.from_numpy(s["flatten_ids"]),
        backgrounds=None if bg is None else torch.from_numpy(bg))
    torch.testing.assert_close(img.detach(), ref_img, rtol=0, atol=1e-6)
    torch.testing.assert_close(alp.detach(), ref_alp, rtol=0, atol=1e-6)


def _two_camera_stream(seed, N=48, width=48, height=32):
    """Two images in one stream, as a training batch of two views."""
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(N, 3)) + [0, 0, 5]).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, size=(N, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 1, size=(N,)).astype(np.float32)
    viewmats = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    viewmats[1, :3, 3] = [0.4, -0.3, 0.2]
    Ks = np.tile(np.array([[50.0, 0, 24], [0, 50, 16], [0, 0, 1]], np.float32), (2, 1, 1))
    radii, means2d, depths, conics, _ = fully_fused_projection(
        jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
        jnp.asarray(viewmats), jnp.asarray(Ks), width, height, opacities=jnp.asarray(opac))
    isect = jtiling.isect_tiles_packed(means2d, radii, depths, 16, 3, 2,
                                       max_tiles_per_gauss=32)
    return dict(
        means2d=np.array(means2d), conics=np.array(conics),
        colors=rng.uniform(0, 1, size=(2, N, 3)).astype(np.float32),
        opacities=np.broadcast_to(opac, (2, N)).copy(),
        offsets=np.array(isect.offsets), flatten_ids=np.array(isect.flatten_ids),
        width=width, height=height,
    )


def test_packed_grads_match_jax_two_images():
    s = _two_camera_stream(430)
    bg = np.array([[0.2, 0.4, 0.6], [0.6, 0.4, 0.2]], np.float32)
    v_img, v_alp = _cotangents(43, 2, s["height"], s["width"], 3)
    want = _jax_grads(s, s["colors"], v_img, v_alp, bg, 1024, abs_tap=True)
    got, img, _ = _port_grads(s, s["colors"], v_img, v_alp, bg, 1024, abs_tap=True)
    assert img.shape == (2, s["height"], s["width"], 3)
    for name, g, w in zip(NAMES + ("abs",), got, want):
        assert g.shape == w.shape, name
        _assert_close(g, w, name)


def test_packed_absgrad_tap_matches_jax():
    s = _projected_stream(420)
    v_img, v_alp = _cotangents(21, 1, s["height"], s["width"], 3)
    want = _jax_grads(s, s["colors"], v_img, v_alp, None, 1024, abs_tap=True)
    got, _, _ = _port_grads(s, s["colors"], v_img, v_alp, None, 1024, abs_tap=True)
    for name, g, w in zip(NAMES + ("abs",), got, want):
        _assert_close(g, w, name)
    # |per-entry| sums dominate the signed sums
    assert (got[4] >= np.abs(got[0]) - 1e-6).all()


def _carry_artefact_slots(offsets, tile_capacity):
    """Stream slots whose gradient the JAX backward returns as zero when a
    truncated tile is followed by a tile that starts in the same 128-entry
    chunk (the carry is invalidated, rasterize_pallas_packed.py:563-565,
    :703-709, :818-843): from that chunk's start to the next tile's start.
    The very last tile has no successor."""
    keep = max_entries_per_tile(tile_capacity)
    counts = np.diff(offsets)
    slots = []
    for t in range(len(counts) - 1):
        if counts[t] > keep:
            end = int(offsets[t + 1])
            slots.extend(range((end // CHUNK) * CHUNK, end))
    return np.array(sorted(set(slots)), np.int64)


def test_packed_truncation_grads_match_jax_with_carry_artefact():
    """Tiles overflow tile_capacity=128. The port gives every kept entry
    its gradient; the JAX backward zeroes the kept entries that share the
    next tile's first chunk. Zeroing exactly those slots in the port's
    per-entry rows gives the JAX gradients; without it they differ."""
    tc = 128
    # every gaussian covers all four tiles: ranges of 160 entries, so the
    # kept entries 128..159 of tiles 1 and 2 share the next tile's chunk
    s = _raster_stream(117, N=160, width=32, height=32, min_radius=20)
    # faint enough that pixels are still open at the cut
    s["opacities"] = (s["opacities"] * 0.05).astype(np.float32)
    offsets = s["offsets"]
    D = s["colors"].shape[-1]
    v_img, v_alp = _cotangents(31, 1, 32, 32, D)
    want = _jax_grads(s, s["colors"], v_img, v_alp, None, tc)

    args = [torch.from_numpy(s[k]) for k in ("means2d", "conics", "colors", "opacities")]
    offs, ids = torch.from_numpy(offsets), torch.from_numpy(s["flatten_ids"])
    img, trans = rasterize_packed_train_fwd_plain(*args, 32, 32, 16, offs, ids, tc)
    rows = rasterize_packed_bwd_plain(
        *args, 32, 32, 16, offs, ids, img, trans,
        torch.from_numpy(v_img), -torch.from_numpy(v_alp)[..., 0], tc)
    slots = _carry_artefact_slots(offsets, tc)
    assert len(slots) and float(rows[slots].abs().max()) > 0.0  # artefact bites
    sids, perm = sort_ids(ids, offs[-1])
    G = args[0].shape[1]

    def per_gaussian(r):
        sums = segment_rows_sum_plain(r, perm, sids, G).numpy()
        return [sums[:, 0:2], sums[:, 2:5], sums[:, 6:], sums[:, 5]]

    emulated = rows.clone()
    emulated[slots] = 0.0
    for name, g, w in zip(NAMES, per_gaussian(emulated), want):
        _assert_close(g.reshape(w.shape), w, name)
    exact = per_gaussian(rows)
    assert float(np.abs(exact[0].reshape(want[0].shape) - want[0]).max()) > (
        RTOL * float(np.abs(want[0]).max()))
    # the autograd path gives the exact (artefact-free) gradients
    got, _, _ = _port_grads(s, s["colors"], v_img, v_alp, None, tc)
    np.testing.assert_allclose(got[0].reshape(-1, 2), exact[0], rtol=0, atol=1e-6)


def test_bwd_rows_zero_past_cut_and_padding():
    """Rows past a tile's cut and past offsets[-1] are zero; the wrapper on
    CPU tensors takes the plain version and launches no kernel."""
    tc = 128
    s = _raster_stream(118, N=300, width=32, height=32, min_radius=24)
    args = [torch.from_numpy(s[k]) for k in ("means2d", "conics", "colors", "opacities")]
    ids = torch.cat([torch.from_numpy(s["flatten_ids"]),
                     torch.zeros(256, dtype=torch.int32)])  # padding slots
    offs = torch.from_numpy(s["offsets"])
    img, trans = rasterize_packed_train_fwd_plain(*args, 32, 32, 16, offs, ids, tc)
    before = dict(_build.LAUNCHES)
    rows = rasterize_packed_bwd_plain(
        *args, 32, 32, 16, offs, ids, img, trans, torch.ones_like(img),
        torch.ones_like(trans), tc)
    assert _build.LAUNCHES == before
    assert rows.shape == (ids.shape[0], 6 + img.shape[-1])
    assert float(rows[int(offs[-1]):].abs().max()) == 0.0
    o = s["offsets"]
    for t in np.nonzero(np.diff(o) > tc)[0]:
        assert float(rows[o[t] + tc:o[t + 1]].abs().max()) == 0.0
        assert float(rows[o[t]:o[t] + tc].abs().max()) > 0.0
