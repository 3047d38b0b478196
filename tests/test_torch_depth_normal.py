"""Port parity of the depth and normal supervision against the JAX package
on the CPU: the sparse and dense depth losses with their gradients, every
function of ``training/normal_losses.py`` (gradients where the trainer
differentiates), the depth colour map, and the COLMAP dataset's normal
maps, sparse point depths and refined depth maps.

Tolerances: values rtol 1e-5 (float32 rounding of the same expressions;
atol 1e-6 near zero), gradients 1e-5 relative to the reference's largest
value (1e-4 through a sum taken in another order: the splat normal's
softmax and rotation, the surface cells' sums); the colour map 1e-6;
labels and dataset items exactly.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.training import losses as jL
from tdgs.training import normal_losses as jNL
from tdgs_torch.training import losses as tL
from tdgs_torch.training import normal_losses as tNL

H, W = 32, 40


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _value_and_grads(jfn, tfn, inputs, argnums):
    """(JAX value, port value, JAX grads, port grads) of a scalar function
    of numpy ``inputs`` with respect to ``argnums``."""
    jv, jg = jax.jit(jax.value_and_grad(jfn, argnums=argnums))(*map(jnp.asarray, inputs))
    leaves = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(inputs)]
    tv = tfn(*leaves)
    tg = torch.autograd.grad(tv, [leaves[i] for i in argnums])
    return float(jv), float(tv.detach()), [np.asarray(g) for g in jg], [g.numpy() for g in tg]


def _check(jfn, tfn, inputs, argnums, rtol=1e-5):
    jv, tv, jg, tg = _value_and_grads(jfn, tfn, inputs, argnums)
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=1e-6)
    for a, b in zip(tg, jg):
        assert np.isfinite(a).all()
        assert _rel(a, b) <= rtol, _rel(a, b)


def _depth_map(rng, batch=(2,)):
    d = rng.uniform(1.0, 5.0, size=batch + (H, W, 1)).astype(np.float32)
    d[..., :3, :5, :] = 0.0  # pixels nothing covers
    return d


@pytest.mark.parametrize("with_valid", [False, True])
def test_depth_loss_sparse_matches_jax(with_valid):
    rng = np.random.default_rng(40)
    depth = _depth_map(rng)
    pts = rng.uniform(-2, [W + 2, H + 2], size=(2, 50, 2)).astype(np.float32)
    pts[0, :4] = [[0.9, 0.2], [-0.7, 3.99], [W - 0.01, H - 1.5], [12.5, 7.5]]  # truncation
    dep = rng.uniform(0.5, 6.0, size=(2, 50)).astype(np.float32)
    valid = (rng.uniform(size=(2, 50)) > 0.3).astype(np.float32)
    if with_valid:
        _check(lambda d, p, z, v: jL.depth_loss_sparse(d, p, z, valid=v),
               lambda d, p, z, v: tL.depth_loss_sparse(d, p, z, valid=v),
               (depth, pts, dep, valid), (0, 2))
    else:
        _check(jL.depth_loss_sparse, tL.depth_loss_sparse, (depth, pts, dep), (0, 2))


def test_depth_loss_dense_matches_jax():
    rng = np.random.default_rng(41)
    depth = _depth_map(rng)
    gt = rng.uniform(1.0, 5.0, size=(2, H, W)).astype(np.float32)
    gt[:, -4:, -6:] = 0.0  # invalid ground truth
    _check(functools.partial(jL.depth_loss_dense, scene_scale=2.5),
           functools.partial(tL.depth_loss_dense, scene_scale=2.5), (depth, gt), (0,))
    # the unselected branch holds no inf: the gradient stays finite where
    # the render is exactly 0
    d = torch.tensor(depth, requires_grad=True)
    tL.depth_loss_dense(d, torch.tensor(gt)).backward()
    assert torch.isfinite(d.grad).all() and float(d.grad[0, :3, :5].abs().max()) == 0.0


def _gaussians(rng, N=200):
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.01, 0.3, size=(N, 3)).astype(np.float32)
    opac = rng.uniform(0.05, 1.0, size=(N,)).astype(np.float32)
    means3d = rng.normal(size=(N, 3)).astype(np.float32)
    means2d = rng.uniform(-3, [W + 3, H + 3], size=(N, 2)).astype(np.float32)
    normals = rng.normal(size=(N, 3)).astype(np.float32)
    nmap = rng.normal(size=(H, W, 3)).astype(np.float32)
    return quats, scales, opac, means3d, means2d, normals, nmap


@pytest.mark.parametrize("rotmat", [False, True])
def test_splat_normal_matches_jax(rotmat):
    rng = np.random.default_rng(42)
    quats, scales, opac = _gaussians(rng)[:3]
    if rotmat:
        from tdgs.ops.transforms import quat_to_rotmat

        quats = np.asarray(quat_to_rotmat(jnp.asarray(quats)))
    want = jNL.calculate_gaussian_splat_normal_differentiable(
        jnp.asarray(quats), jnp.asarray(scales), jnp.asarray(opac))
    got = tNL.calculate_gaussian_splat_normal_differentiable(
        torch.tensor(quats), torch.tensor(scales), torch.tensor(opac))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    rng_c = np.random.default_rng(5)
    cot = rng_c.normal(size=(200, 3)).astype(np.float32)

    def jf(q, s):
        n, c = jNL.calculate_gaussian_splat_normal_differentiable(q, s, jnp.asarray(opac))
        return (n * cot).sum() + c.sum()

    def tf(q, s):
        n, c = tNL.calculate_gaussian_splat_normal_differentiable(q, s, torch.tensor(opac))
        return (n * torch.tensor(cot)).sum() + c.sum()

    _check(jf, tf, (quats, scales), (0, 1), rtol=1e-4)


@pytest.mark.parametrize("loss_type", ["cosine", "angular", "combined", "robust", "progressive"])
def test_normal_losses_match_jax(loss_type):
    rng = np.random.default_rng(43)
    g, s = rng.normal(size=(2, 200, 3)).astype(np.float32)
    if loss_type == "progressive":
        _check(jNL.compute_progressive_normal_loss, tNL.compute_progressive_normal_loss,
               (g, s), (0, 1))
    else:
        _check(functools.partial(jNL.compute_normal_loss, loss_type=loss_type),
               functools.partial(tNL.compute_normal_loss, loss_type=loss_type), (g, s), (0, 1))
    with pytest.raises(ValueError):
        tNL.compute_normal_loss(torch.tensor(g), torch.tensor(s), "l2")


def test_sample_normals_and_masked_loss_match_jax():
    """The bilinear sample's gradient reaches the centres, and the masked
    loss's the normals, as the trainer's monocular-normal term takes them."""
    rng = np.random.default_rng(44)
    _, _, _, _, means2d, normals, nmap = _gaussians(rng)
    visible = rng.uniform(size=200) > 0.3

    def jf(n, m2d, nm):
        return jNL.masked_progressive_normal_loss(
            n, jNL.sample_normals_from_map(nm, m2d), jnp.asarray(visible))

    def tf(n, m2d, nm):
        return tNL.masked_progressive_normal_loss(
            n, tNL.sample_normals_from_map(nm, m2d), torch.tensor(visible))

    _check(jf, tf, (normals, means2d, nmap), (0, 1, 2))
    np.testing.assert_allclose(
        tNL.sample_normals_from_map(torch.tensor(nmap), torch.tensor(means2d)).numpy(),
        np.asarray(jNL.sample_normals_from_map(jnp.asarray(nmap), jnp.asarray(means2d))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_smooth_normals_matches_jax(kernel_size):
    nmap = np.random.default_rng(45).normal(size=(H, W, 3)).astype(np.float32)
    got = tNL.smooth_normals(torch.tensor(nmap), kernel_size)
    want = jNL.smooth_normals(jnp.asarray(nmap), kernel_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_depth_smoothness_and_consistency_match_jax():
    rng = np.random.default_rng(46)
    depth = _depth_map(rng, ())
    image = rng.uniform(size=(H, W, 3)).astype(np.float32)
    n1, n2 = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    alpha = rng.uniform(size=(H, W, 1)).astype(np.float32)
    _check(jNL.depth_smoothness_loss, tNL.depth_smoothness_loss, (depth, image), (0,))
    _check(jNL.normal_consistency_loss, tNL.normal_consistency_loss, (n1, n2, alpha), (0, 1))
    _check(jNL.normal_consistency_loss, tNL.normal_consistency_loss, (n1, n2), (0, 1))


def test_normal_total_variation_of_depth_normals_matches_jax():
    """The trainer's normalconsist chain (depth → normals → total variation)
    with its holes: where neighbouring normals are equal, JAX's |x| passes
    the gradient on (+1 at 0), and so does the port's."""
    from tdgs.utils.depth import depth_to_normal as jd2n
    from tdgs_torch.utils.depth import depth_to_normal as td2n

    rng = np.random.default_rng(47)
    depth = _depth_map(rng, ())
    depth[10:16, 8:20] = 0.0
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, 0.2, 0.3]
    K = np.array([[50, 0, W / 2], [0, 50, H / 2], [0, 0, 1]], np.float32)

    def jf(d):
        dn = jd2n(d, jnp.asarray(c2w), jnp.asarray(K))
        return jnp.abs(dn[:, 1:] - dn[:, :-1]).mean() + jnp.abs(dn[1:] - dn[:-1]).mean()

    def tf(d):
        return tNL.normal_total_variation(td2n(d, torch.tensor(c2w), torch.tensor(K)))

    _check(jf, tf, (depth,), (0,))


def test_render_normals_match_jax():
    rng = np.random.default_rng(48)
    N = 120
    # distinct pixels inside, and centres outside that clip to the border
    flat = rng.choice((H - 2) * (W - 2), size=N, replace=False)
    means2d = np.stack([flat % (W - 2) + 1, flat // (W - 2) + 1], -1).astype(np.float32)
    means2d += rng.uniform(-0.4, 0.4, size=means2d.shape).astype(np.float32)
    means2d[:6] = [[-9, 5], [-9, 5], [W + 9, 7], [3, H + 9], [3, H + 9], [-50, -50]]
    normals = rng.normal(size=(N, 3)).astype(np.float32)
    for k in (3, 5):
        got = tNL.render_normals_with_interpolation(torch.tensor(normals),
                                                    torch.tensor(means2d), H, W, k)
        want = jNL.render_normals_with_interpolation(jnp.asarray(normals),
                                                     jnp.asarray(means2d), H, W, k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got = tNL.render_normals_simple(torch.tensor(normals), torch.tensor(means2d), H, W)
    want = jNL.render_normals_simple(jnp.asarray(normals), jnp.asarray(means2d), H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_surface_clusters_and_consistency_match_jax():
    rng = np.random.default_rng(49)
    means3d = (rng.normal(size=(300, 3)) * 0.3).astype(np.float32)
    normals = rng.normal(size=(300, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    means3d[150:] = means3d[:150] + 0.001  # shared cells
    normals[150:] = normals[:150]
    got = tNL.cluster_gaussians_by_surface(torch.tensor(means3d), torch.tensor(normals), 0.2)
    want = jNL.cluster_gaussians_by_surface(jnp.asarray(means3d), jnp.asarray(normals), 0.2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) < 300
    # the cells' sums are taken in another order (index_add against
    # segment_sum): the gradient within 1e-4
    _check(functools.partial(jNL.apply_surface_consistency_loss, cluster_threshold=0.2),
           functools.partial(tNL.apply_surface_consistency_loss, cluster_threshold=0.2),
           (normals + 0.05 * rng.normal(size=normals.shape).astype(np.float32), means3d),
           (0,), rtol=1e-4)


def test_spatial_smoothness_matches_jax():
    rng = np.random.default_rng(50)
    _, _, _, means3d, means2d, normals, _ = _gaussians(rng, N=150)
    _check(functools.partial(jNL.add_spatial_smoothness_loss, k_neighbors=6),
           functools.partial(tNL.add_spatial_smoothness_loss, k_neighbors=6),
           (normals, means2d, means3d), (0, 2))


def test_depth_colormap_matches_jax():
    from tdgs.utils import viz as jviz
    from tdgs_torch.utils import viz as tviz

    rng = np.random.default_rng(51)
    depth = rng.uniform(1.0, 9.0, size=(H, W, 1)).astype(np.float32)
    depth[0, 0] = np.nan
    acc = rng.uniform(size=(H, W, 1)).astype(np.float32)
    for kw in ({}, dict(acc=acc), dict(near_plane=2.0, far_plane=6.0)):
        d = np.nan_to_num(depth, nan=0.0) if not kw else depth
        np.testing.assert_allclose(tviz.apply_depth_colormap(d, **kw),
                                   jviz.apply_depth_colormap(d, **kw), atol=1e-6)
    x = rng.uniform(size=(H, W, 1)).astype(np.float32)
    np.testing.assert_array_equal(tviz.apply_float_colormap(x, "gray"),
                                  jviz.apply_float_colormap(x, "gray"))
    with pytest.raises(ValueError):
        tviz.apply_float_colormap(x + 1.5)


def test_save_image_writes_what_jax_writes(tmp_path):
    from PIL import Image

    from tdgs.utils import viz as jviz
    from tdgs_torch.utils import viz as tviz

    img = np.random.default_rng(52).uniform(-0.1, 1.1, size=(1, 3, 12, 16)).astype(np.float32)
    tviz.save_image(img, str(tmp_path / "t" / "a.png"))
    jviz.save_image(img, str(tmp_path / "j.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / "a.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


@pytest.fixture(scope="module")
def tracked_scene(tmp_path_factory):
    from tdgs_torch.utils.png import write_png
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    import os

    root = str(tmp_path_factory.mktemp("tracked"))
    make_colmap_test_scene(root, device="cpu", tracks=True)
    rng = np.random.default_rng(53)
    os.makedirs(os.path.join(root, "normals"))
    os.makedirs(os.path.join(root, "refined_depths"))
    for i in range(8):
        # the refined depths at twice the image size (nearest-resized back)
        np.save(os.path.join(root, "refined_depths", f"img_{i:03d}_refined_depth.npy"),
                rng.uniform(1, 5, size=(96, 128)).astype(np.float32))
        if i % 2:
            np.save(os.path.join(root, "normals", f"img_{i:03d}.npy"),
                    rng.normal(size=(48, 64, 3)).astype(np.float32))
        else:  # an RGB encoding, at half the image size
            write_png(os.path.join(root, "normals", f"img_{i:03d}.png"),
                      rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8))
    return root


@pytest.mark.parametrize("patch_size", [None, 24])
def test_dataset_normals_and_depths_match_jax(tracked_scene, patch_size):
    from tdgs.datasets import Dataset as JDataset
    from tdgs.datasets import Parser as JParser
    from tdgs_torch.datasets import Dataset, Parser

    kw = dict(factor=1, normalize=True, test_every=4, load_normals=True)
    jp, tp = JParser(tracked_scene, **kw), Parser(tracked_scene, **kw)
    assert jp.point_indices.keys() == tp.point_indices.keys()
    for k in jp.point_indices:
        np.testing.assert_array_equal(tp.point_indices[k], jp.point_indices[k])
    jset = JDataset(jp, "train", patch_size=patch_size, load_depths=True)
    tset = Dataset(tp, "train", patch_size=patch_size, load_depths=True)
    tset.enable_prefetch(n_threads=2)
    tset.prefetch(np.arange(len(tset)))
    try:
        for i in range(len(tset)):
            np.random.seed(200 + i)
            want = jset[i]
            np.random.seed(200 + i)
            got = tset[i]
            assert got.keys() == want.keys()
            assert len(got["points"]) > 50
            for k in ("image", "K", "viewmat", "normal", "points", "depths", "refined_depth"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        tset.close()
    # nothing extra is read unless asked for
    plain = Dataset(Parser(tracked_scene, factor=1, test_every=4), "train")[0]
    assert not {"normal", "points", "refined_depth"} & plain.keys()
