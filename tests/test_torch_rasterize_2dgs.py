"""Port parity of the packed 2DGS rasterizer: the plain versions of kernels
4, 5 and 6 behind ``tdgs_torch.ops.rasterize_2dgs_packed`` against the JAX
package's ``rasterize_2dgs_pallas`` (Pallas in interpret mode on the CPU,
as the JAX package's own tests run it), over one shared stream: means2d,
ray transforms, normals, offsets and flatten_ids come from the JAX
package's projection and tiling and are handed to both.

The JAX package's rasterizers take the ray-splat cross products over the
rows of its ray transform M = (K [RS_u, RS_v, mean_c])ᵀ, that is over the
transposed matrix, so its σ3d hardly depends on the pixel
(``test_reference_fault_ray_transform_transposed``). The port takes them
over M's columns. The parity tests hand the Pallas functions Mᵀ, which
makes them compute what the port computes (ROADMAP, faults on the
reference side).

Tolerances: forward outputs 2e-3 absolute (the Pallas kernels take the
transmittance prefix in log space, the plain versions a running product);
median depth, a selected entry, may differ in at most 0.5% of the pixels;
gradients max|Δ| ≤ 1e-3 · max|ref| per input. The scale-relative form is
also what tests/test_2dgs.py:207-214 uses for the min(σ3d, σ2d) branch
boundary: the port forms the cross products t0/tpx/tpy in PyTorch, and a
pixel sitting on the boundary may take the other branch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops import tiling as jtiling
from tdgs.ops.projection_2dgs import fully_fused_projection_2dgs as j_project
from tdgs.ops.rasterize_2dgs_pallas import (
    rasterize_to_pixels_2dgs_packed as j_train,
    rasterize_to_pixels_2dgs_packed_inference as j_inference,
)
from tdgs_torch.ops import _build
from tdgs_torch.ops.rasterize_2dgs_packed import (
    GEOM_COLS,
    feature_rows,
    padded_width,
    rasterize_2dgs_bwd_plain,
    rasterize_2dgs_fwd_plain,
    rasterize_2dgs_inference,
    rasterize_to_pixels_2dgs_packed,
    rasterize_to_pixels_2dgs_packed_inference,
)
from tdgs_torch.ops.segment_sum import segment_rows_sum_plain, sort_ids
from tests.test_2dgs import make_surfel_scene
from tests.test_torch_rasterize_packed_grad import _carry_artefact_slots

ATOL = 2e-3
RTOL = 1e-3
NAMES = ("means2d", "ray_transforms", "colors", "normals", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _surfel_stream(seed, N=48, C=1, width=64, height=48, min_scale=0.0):
    """Projected surfels + packed stream from the JAX package; colours are
    RGB + depth (D = 4), as render_mode "RGB+ED" gives the rasterizer.
    Every third surfel is shrunk below a pixel, so that the σ2d low-pass
    branch, the only one that reads means2d, carries gradients too."""
    rng = np.random.default_rng(seed)
    means, quats, scales, opac, colors, viewmats, Ks, w, h = make_surfel_scene(
        rng, N=N, C=C, width=width, height=height)
    scales[::3] *= 0.08
    scales = np.maximum(scales, min_scale)
    radii, means2d, depths, M, normals = j_project(
        *map(jnp.asarray, (means, quats, scales, viewmats, Ks)), w, h)
    tw, th = -(-w // 16), -(-h // 16)
    isect = jtiling.isect_tiles_packed(means2d, radii, depths, 16, tw, th,
                                       max_tiles_per_gauss=16)
    cols = np.concatenate([np.broadcast_to(colors, (C, N, 3)),
                           np.asarray(depths)[..., None]], -1).astype(np.float32)
    return dict(
        means2d=np.array(means2d), ray_transforms=np.array(M), colors=cols,
        normals=np.array(normals), opacities=np.broadcast_to(opac, (C, N)).copy(),
        offsets=np.array(isect.offsets), flatten_ids=np.array(isect.flatten_ids),
        width=w, height=h,
    )


def _inputs(s, lib):
    """The rasterizer's inputs; the JAX side gets Mᵀ (see the module doc)."""
    if lib == "jax":
        return [jnp.asarray(np.swapaxes(s[k], -1, -2) if k == "ray_transforms" else s[k])
                for k in NAMES]
    return [torch.from_numpy(s[k]) for k in NAMES]


def _stream_args(s, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return (s["width"], s["height"], 16, conv(s["offsets"]), conv(s["flatten_ids"]))


def test_reference_fault_ray_transform_transposed():
    """One surfel facing the camera (scale 0.1 at depth 5, focal 60): the
    port's σ3d at r pixels from the centre is the surfel's own
    (r·5/60/0.1)², the JAX rasterizer's hardly changes with r, and the
    Pallas function handed Mᵀ agrees with the port."""
    means, quats = np.array([[0.0, 0.0, 5.0]], np.float32), np.array([[1.0, 0, 0, 0]], np.float32)
    scales = np.full((1, 3), 0.1, np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None]
    Ks = np.array([[[60.0, 0, 32], [0, 60, 24], [0, 0, 1]]], np.float32)
    radii, means2d, depths, M, normals = j_project(
        *map(jnp.asarray, (means, quats, scales, viewmats, Ks)), 64, 48)
    isect = jtiling.isect_tiles_packed(means2d, radii, depths, 16, 4, 3)
    args = dict(means2d=means2d, colors=jnp.ones((1, 1, 3)), normals=normals,
                opacities=jnp.full((1, 1), 0.9))
    stream = (64, 48, 16, isect.offsets, isect.flatten_ids)

    def alpha_row(M_given, port=False):
        if port:
            out = rasterize_to_pixels_2dgs_packed_inference(
                *(torch.from_numpy(np.array(x)) for x in (
                    args["means2d"], M_given, args["colors"], args["normals"],
                    args["opacities"])),
                *stream[:3], *(torch.from_numpy(np.array(x)) for x in stream[3:]))
            return out[1].numpy()[0, 24, 32:36, 0]
        out = j_inference(args["means2d"], M_given, args["colors"], args["normals"],
                          args["opacities"], *stream)
        return np.asarray(out[1])[0, 24, 32:36, 0]

    r2 = (np.arange(4) + 0.5) ** 2 + 0.25  # pixel centres on row 24
    want = 0.9 * np.exp(-0.5 * np.minimum((5 / 60 / 0.1) ** 2 * r2, 2 * r2))
    port = alpha_row(M, port=True)
    np.testing.assert_allclose(port, want, rtol=1e-4)
    np.testing.assert_allclose(alpha_row(jnp.swapaxes(M, -1, -2)), port, atol=1e-5)
    reference = alpha_row(M)
    assert reference.min() > 0.89  # α ≈ opacity over the whole footprint


def test_plain_inference_matches_pallas():
    s = _surfel_stream(500)
    bg = np.array([[0.2, 0.7, 0.4, 0.0]], np.float32)
    want = j_inference(*_inputs(s, "jax"), *_stream_args(s, "jax"),
                       backgrounds=jnp.asarray(bg), tile_capacity=256)
    before = dict(_build.LAUNCHES)
    got = rasterize_to_pixels_2dgs_packed_inference(
        *_inputs(s, "torch"), *_stream_args(s, "torch"),
        backgrounds=torch.from_numpy(bg), tile_capacity=256)
    assert _build.LAUNCHES == before  # the plain version, no kernel on the CPU
    for name, g, w in zip(("colors", "alphas", "normals"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)
    assert float(got[1].max()) > 0.5  # the surfels cover pixels


def _cotangents(seed, s):
    rng = np.random.default_rng(seed)
    H, W = s["height"], s["width"]
    return [rng.normal(size=(1, H, W, k)).astype(np.float32) for k in (4, 1, 3, 1)]


def _jax_train(s, cot, tile_capacity, bg=None):
    """Outputs and jax.grad of Σ <out, cotangent> through the Pallas pair;
    the last gradient is the AbsGS tap's."""
    G = s["means2d"].shape[0] * s["means2d"].shape[1]

    def run(*xs):
        *inputs, dummy = xs
        return j_train(*inputs, *_stream_args(s, "jax"),
                       backgrounds=None if bg is None else jnp.asarray(bg),
                       tile_capacity=tile_capacity, has_depth=True,
                       compute_distort=True, absgrad_dummy=dummy)

    def loss(*xs):
        outs = run(*xs)
        return sum(jnp.sum(o * c) for o, c in zip(outs[:4], cot))

    xs = _inputs(s, "jax") + [jnp.zeros((G, 2), jnp.float32)]
    outs = run(*xs)
    grads = [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(*xs)]
    grads[1] = np.swapaxes(grads[1], -1, -2)  # d/dMᵀ → d/dM
    return [np.asarray(o) for o in outs], grads


def _port_train(s, cot, tile_capacity, bg=None):
    G = s["means2d"].shape[0] * s["means2d"].shape[1]
    leaves = [x.clone().requires_grad_(True) for x in _inputs(s, "torch")]
    dummy = torch.zeros((G, 2), requires_grad=True)
    outs = rasterize_to_pixels_2dgs_packed(
        *leaves, *_stream_args(s, "torch"),
        backgrounds=None if bg is None else torch.from_numpy(bg),
        tile_capacity=tile_capacity, has_depth=True, compute_distort=True,
        absgrad_dummy=dummy)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs[:4], cot))
    grads = torch.autograd.grad(loss, leaves + [dummy])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _assert_outputs_close(got, want):
    for name, g, w in zip(("colors", "alphas", "normals", "distortion"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=name)
    differ = np.abs(got[4] - want[4]) > 1e-5
    assert differ.mean() <= 0.005, f"median differs in {differ.mean():.2%} of pixels"


def _assert_grads_close(got, want, names):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert scale > 0.0, name
        assert err <= RTOL * scale, f"{name}: max|Δ| {err} > {RTOL} · {scale}"


def test_plain_train_forward_and_grads_match_pallas():
    """Kernels 5 and 6 (plain) and the segment sum behind autograd against
    the Pallas training pair: all five outputs, then the gradients of every
    input and of the AbsGS tap."""
    s = _surfel_stream(501)
    bg = np.array([[0.3, 0.5, 0.7, 0.0]], np.float32)
    cot = _cotangents(11, s)
    want_o, want_g = _jax_train(s, cot, 256, bg)
    got_o, got_g = _port_train(s, cot, 256, bg)
    _assert_outputs_close(got_o, want_o)
    assert float(want_o[3].max()) > 0.0 and float(want_o[4].max()) > 1.0
    _assert_grads_close(got_g, want_g, NAMES + ("abs_tap",))
    # |per-entry| sums dominate the signed sums of means2d
    assert (got_g[5] >= np.abs(got_g[0].reshape(-1, 2)) - 1e-5).all()


def test_plain_truncation_matches_pallas_with_carry_artefact():
    """Big surfels over a 32×32 image: every tile's range overflows
    tile_capacity = 128. The forwards agree. The port gives every kept
    entry its gradient; the JAX backward zeroes the kept entries of a
    truncated tile that share the next tile's first 128-entry chunk.
    Zeroing exactly those slots in the port's per-entry rows gives the JAX
    gradients; without it they differ. (About 13 s on one CPU worker:
    four tiles of about 150 entries, two chunks each, in interpret mode.)"""
    tc = 128
    s = _surfel_stream(503, N=200, width=32, height=32, min_scale=0.4)
    counts = np.diff(s["offsets"])
    assert (counts[:-1] > tc).sum() >= 2
    cot = _cotangents(13, s)
    want_o, want_g = _jax_train(s, cot, tc)
    got_o, _ = _port_train(s, cot, tc)
    _assert_outputs_close(got_o, want_o)

    # the port's per-entry rows for the same cotangents (no background:
    # the cotangent of T is minus the alpha's)
    leaves = [x.clone().requires_grad_(True) for x in _inputs(s, "torch")]
    feats = feature_rows(*leaves)
    offs, ids = torch.from_numpy(s["offsets"]), torch.from_numpy(s["flatten_ids"])
    rows = feats.detach()[ids.long()]
    img, nrm, T, dist, _, _ = rasterize_2dgs_fwd_plain(rows, offs, 1, 4, 32, 32, 16, tc,
                                                       depth_row=3, compute_distort=True)
    v_img, v_alp, v_nrm, v_dist = (torch.from_numpy(c) for c in cot)
    v_rows = rasterize_2dgs_bwd_plain(rows, offs, 1, 4, 32, 32, 16, img, nrm, T, dist,
                                      v_img, v_nrm, -v_alp[..., 0], v_dist[..., 0], tc,
                                      depth_row=3, compute_distort=True)
    slots = _carry_artefact_slots(s["offsets"], tc)
    assert len(slots) and float(v_rows[slots].abs().max()) > 0.0  # the artefact bites
    sids, perm = sort_ids(ids, offs[-1])

    def per_input(r):
        sums = segment_rows_sum_plain(r, perm, sids, feats.shape[0])
        return [g.numpy() for g in torch.autograd.grad(feats, leaves, sums,
                                                       retain_graph=True)]

    emulated = v_rows.clone()
    emulated[slots] = 0.0
    _assert_grads_close(per_input(emulated), want_g, NAMES)
    exact = per_input(v_rows)
    assert np.abs(exact[0] - want_g[0]).max() > RTOL * np.abs(want_g[0]).max()
    assert v_rows.shape == (ids.shape[0], GEOM_COLS + 7)
    # rows past each tile's cut and past offsets[-1] are zero
    o = s["offsets"]
    assert float(v_rows[int(o[-1]):].abs().sum()) == 0.0
    for t in np.nonzero(np.diff(o) > tc)[0]:
        assert float(v_rows[o[t] + tc:o[t + 1]].abs().max()) == 0.0


@pytest.mark.parametrize("tile_capacity", [128, 1024])
def test_plain_through_flatten_ids_equals_gathered_rows(tile_capacity):
    """The plain version of kernels 4 and 5 on per-gaussian rows read
    through flatten_ids gives, bit for bit, what it gives on the same rows
    gathered into stream order, distortion and median included; so does
    kernel 4's wrapper on CPU tensors, from rows at the kernel's padded
    stride."""
    s = _surfel_stream(511, N=120)
    feats = feature_rows(*_inputs(s, "torch"))
    offs, ids = torch.from_numpy(s["offsets"]), torch.from_numpy(s["flatten_ids"])
    geo = (offs, 1, 4, s["width"], s["height"], 16, tile_capacity)
    want = rasterize_2dgs_fwd_plain(feats[ids.long()], *geo, depth_row=3, compute_distort=True)
    got = rasterize_2dgs_fwd_plain(feats, *geo, depth_row=3, compute_distort=True,
                                   flatten_ids=ids)
    assert float(want[3].abs().max()) > 0 and float(want[4].abs().max()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    padded = feature_rows(*_inputs(s, "torch"), width=padded_width(4))
    assert padded.shape[1] == 20 and float(padded[:, GEOM_COLS + 7:].abs().max()) == 0.0
    img, alp, nrm = rasterize_2dgs_inference(padded, ids, *geo[:-1], None, tile_capacity)
    assert torch.equal(img, want[0]) and torch.equal(nrm, want[1])
    assert torch.equal(alp[..., 0], 1.0 - want[2])


@pytest.mark.parametrize("bad", ["unpadded_rows", "int64_ids", "int64_offsets",
                                 "split_not_dividing"])
def test_inference_wrapper_checks_the_kernels_inputs_on_cpu(bad):
    """Kernel 4's wrapper holds CPU tensors to the inputs the kernel takes
    on the card: rows at the padded stride, int32 ids and offsets, a split
    that divides the tile's warps."""
    s = _surfel_stream(160, N=30)
    feats = feature_rows(*_inputs(s, "torch"), width=padded_width(4))
    offs, ids = torch.from_numpy(s["offsets"]), torch.from_numpy(s["flatten_ids"])
    args = dict(feats=feats, flatten_ids=ids, offsets=offs)
    kw = {}
    if bad == "unpadded_rows":
        args["feats"] = feats[:, :GEOM_COLS + 7].contiguous()
    elif bad == "int64_ids":
        args["flatten_ids"] = ids.long()
    elif bad == "int64_offsets":
        args["offsets"] = offs.long()
    else:
        kw["n_split"] = 3
    geo = (1, 4, s["width"], s["height"], 16)
    rasterize_2dgs_inference(feats, ids, offs, *geo)  # the inputs as they should be
    with pytest.raises((TypeError, ValueError)):
        rasterize_2dgs_inference(*args.values(), *geo, **kw)
