"""Port parity of identity-vector segmentation: ``tdgs_torch.segmentation``
against ``tdgs.segmentation`` on the same seeded numpy inputs.

Tolerances: the head and its gradients 1e-6 relative to the reference's
largest magnitude (float32 sums of 16 and 64 products); each loss and its
gradient 1e-5 relative to the reference's largest magnitude; K-means
labels equal and centroids within 1e-5. The inputs have no ties:
positions and features are continuous draws and the clusters are far
apart, so ``top_k``/``topk`` and ``argmin`` pick the same indices in both
packages (with ties either pick is right, and the two may differ)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.segmentation import clustering as jclu
from tdgs.segmentation import head as jhead
from tdgs.segmentation import losses as jlos
from tdgs_torch.segmentation import clustering as tclu
from tdgs_torch.segmentation import head as thead
from tdgs_torch.segmentation import losses as tlos

HEAD_RTOL = 1e-6
LOSS_RTOL = 1e-5


def _close_rel(got, want, rtol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max|Δ| {err} > {rtol} · {scale}"


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def test_head_forward_and_gradients_match():
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(16, 64)) * 0.35, "b1": rng.normal(size=64) * 0.1,
              "w2": rng.normal(size=(64, 16)) * 0.18, "b2": rng.normal(size=16) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(50, 16)).astype(np.float32)
    cot = rng.normal(size=(50, 16)).astype(np.float32)

    def j_loss(p, x):
        return jnp.sum(jhead.apply_segmentation_head(p, x) * cot)

    want = jax.jit(jhead.apply_segmentation_head)({k: jnp.asarray(v) for k, v in params.items()},
                                                  jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))

    head = thead.head_from_numpy(params, device="cpu")
    xt = _t(x, grad=True)
    out = head(xt)
    _close_rel(out.detach(), want, HEAD_RTOL, "forward")
    grads = torch.autograd.grad((out * _t(cot)).sum(), list(head.params().values()) + [xt])
    for name, g in zip(thead.PARAM_NAMES, grads):
        _close_rel(g, gp[name], HEAD_RTOL, name)
    _close_rel(grads[-1], gx, HEAD_RTOL, "x")
    assert list(thead.head_to_numpy(head)) == ["w1", "b1", "w2", "b2"]


def test_head_init_layout():
    g = torch.Generator().manual_seed(0)
    head = thead.init_segmentation_head(g, 16, 64, 16, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in head.params().items()}
    assert shapes == {"w1": (16, 64), "b1": (64,), "w2": (64, 16), "b2": (16,)}
    assert not head.b1.any() and not head.b2.any()
    assert abs(float(head.w1.detach().std()) - (2 / 16) ** 0.5) < 0.05


def _mask_scene(seed, H=40, W=48, n_inst=4, D=16, zero_background=True):
    """A feature map whose instances are blobs of nearby features and whose
    background (id 0) renders exactly zero, with its instance mask."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((H, W), np.int32)
    for i in range(1, n_inst + 1):
        y0, x0 = rng.integers(0, H - 12), rng.integers(0, W - 12)
        mask[y0:y0 + 10, x0:x0 + 11] = i  # 110 pixels, later ids on top
    centers = rng.normal(size=(n_inst + 1, D))
    fmap = centers[mask] + rng.normal(size=(H, W, D)) * 0.6
    if zero_background:
        fmap[mask == 0] = 0.0
    return fmap.astype(np.float32), mask


@pytest.mark.parametrize("case", ["four_instances", "one_instance", "background_only"])
def test_cgc_clustering_loss_and_gradient_match(case):
    fmap, mask = _mask_scene(1)
    if case == "one_instance":
        mask = np.where(mask == 2, 2, 0).astype(np.int32)  # n_valid < 2
    elif case == "background_only":
        mask = np.zeros_like(mask)
        fmap = np.zeros_like(fmap)
    kw = dict(max_instances=8, min_cluster_size=30)
    fn = lambda f: jlos.cgc_contrastive_clustering_loss(f, jnp.asarray(mask), **kw)  # noqa
    want, gwant = jax.jit(jax.value_and_grad(fn))(jnp.asarray(fmap))
    f = _t(fmap, grad=True)
    got = tlos.cgc_contrastive_clustering_loss(f, _t(mask), **kw)
    (g,) = torch.autograd.grad(got, [f])
    assert torch.isfinite(g).all()
    if case == "four_instances":
        assert float(want) > 0.1
        _close_rel(got.detach(), want, LOSS_RTOL, "loss")
        _close_rel(g, gwant, LOSS_RTOL, "grad")
    else:
        assert float(got.detach()) == float(want) == 0.0
        assert not g.any() and not np.asarray(gwant).any()


def test_contrastive_segmentation_loss_and_gradient_match():
    fmap, mask = _mask_scene(2, n_inst=3)
    fn = lambda f: jlos.contrastive_segmentation_loss(f, jnp.asarray(mask), max_instances=8)  # noqa
    want, gwant = jax.jit(jax.value_and_grad(fn))(jnp.asarray(fmap))
    f = _t(fmap, grad=True)
    got = tlos.contrastive_segmentation_loss(f, _t(mask), max_instances=8)
    (g,) = torch.autograd.grad(got, [f])
    _close_rel(got.detach(), want, LOSS_RTOL, "loss")
    _close_rel(g, gwant, LOSS_RTOL, "grad")
    one = np.where(mask == 1, 1, 0).astype(np.int32)
    assert float(tlos.contrastive_segmentation_loss(f, _t(one), max_instances=8)) == 0.0


def test_cluster_quality_and_gradient_match():
    # no exactly-zero pixel here: the reference's norm has a NaN gradient at 0
    fmap, mask = _mask_scene(3, zero_background=False)

    def fn(f):
        intra, inter = jlos.cluster_quality(f, jnp.asarray(mask), max_instances=8)
        return intra + 0.5 * inter, (intra, inter)

    (_, (wi, we)), gwant = jax.jit(jax.value_and_grad(fn, has_aux=True))(jnp.asarray(fmap))
    f = _t(fmap, grad=True)
    gi, ge = tlos.cluster_quality(f, _t(mask), max_instances=8)
    (g,) = torch.autograd.grad(gi + 0.5 * ge, [f])
    _close_rel(gi.detach(), wi, LOSS_RTOL, "intra")
    _close_rel(ge.detach(), we, LOSS_RTOL, "inter")
    _close_rel(g, gwant, LOSS_RTOL, "grad")


@pytest.mark.parametrize("n,num_samples", [(300, 8192), (300, 128), (6, 8192)],
                         ids=["all_rows", "sampled", "too_few"])
def test_spatial_regularizer_fed_jax_draws_matches(monkeypatch, n, num_samples):
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(num_samples=num_samples, k_near=2, k_far=5, lambda_near=0.05, lambda_far=0.15)
    fn = lambda f: jlos.cgc_spatial_regularizer(f, jnp.asarray(pos), key, **kw)  # noqa
    want, gwant = jax.jit(jax.value_and_grad(fn))(jnp.asarray(feats))
    draws = np.asarray(jax.random.permutation(key, n))[:min(num_samples, n)]
    monkeypatch.setattr(tlos, "sample_indices",
                        lambda gen, N, S: torch.from_numpy(draws[:S].astype(np.int64)))
    f = _t(feats, grad=True)
    got = tlos.cgc_spatial_regularizer(f, _t(pos), torch.Generator().manual_seed(0), **kw)
    if n < 8:
        assert float(got.detach()) == float(want) == 0.0
        return
    (g,) = torch.autograd.grad(got, [f])
    _close_rel(got.detach(), want, LOSS_RTOL, "loss")
    _close_rel(g, gwant, LOSS_RTOL, "grad")


def test_spatial_regularizer_own_draw_is_a_permutation():
    g = torch.Generator().manual_seed(1)
    idx = tlos.sample_indices(g, 50, 20)
    assert idx.shape == (20,) and len(set(idx.tolist())) == 20 and int(idx.max()) < 50


def _clusters(seed, n_per=60, K=4, D=16):
    """K far-apart clusters of points in D dimensions, anchors near their
    centres (labels have no near-ties)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(K, D)) * 3.0
    X = np.concatenate([c + rng.normal(size=(n_per, D)) * 0.3 for c in centers])
    X = X[rng.permutation(len(X))].astype(np.float32)
    init = (centers + rng.normal(size=centers.shape) * 0.5).astype(np.float32)
    return X, init


def test_kmeans_matches():
    X, init = _clusters(5)
    wl, wc = jclu.kmeans(jnp.asarray(X), jnp.asarray(init), iters=50)
    gl, gc = tclu.kmeans(X, init, iters=50, device="cpu")
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=0, atol=1e-5)
    # a centroid that loses every point stays where it was
    far = np.concatenate([init, np.full((1, 16), 100.0, np.float32)])
    wl, wc = jclu.kmeans(jnp.asarray(X), jnp.asarray(far), iters=5)
    gl, gc = tclu.kmeans(X, far, iters=5, device="cpu")
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=0, atol=1e-5)


def test_anchor_kmeans_background_matches():
    rng = np.random.default_rng(6)
    fmap, mask = _mask_scene(6, n_inst=3)
    # per-gaussian encodings around the instance features, plus outliers
    centers = np.stack([fmap[mask == i].mean(0) for i in (1, 2, 3)])
    enc = np.concatenate([c + rng.normal(size=(80, 16)) * 0.4 for c in centers]
                         + [rng.normal(size=(12, 16)) * 3.0]).astype(np.float32)
    wa, wids = jclu.anchor_centroids_from_identity_map(fmap, mask)
    ga, gids = tclu.anchor_centroids_from_identity_map(fmap, mask)
    np.testing.assert_array_equal(gids, wids)
    np.testing.assert_array_equal(ga, wa)
    want = jclu.kmeans_identity_encodings_background(fmap, mask, enc)
    got = tclu.kmeans_identity_encodings_background(fmap, mask, torch.from_numpy(enc),
                                                    device="cpu")
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["fg_ids"], want["fg_ids"])
    np.testing.assert_allclose(got["centroids"], want["centroids"], rtol=0, atol=1e-5)
    assert (got["labels"] == -1).sum() >= 1 and len(set(got["labels"].tolist())) == 4


def test_chain_clusters_only_live_rows():
    """The chain's clustering (``rally_e2e.cluster_live_rows``) leaves the
    capacity's dead rows, which share one encoding, out of the K-means.
    Clustered with the live rows, as the JAX example does before its
    opacity cut, they capture an anchor and an instance is lost."""
    from tdgs_torch.rally_e2e import cluster_live_rows

    rng = np.random.default_rng(6)
    fmap, mask = _mask_scene(6, n_inst=3)
    centers = np.stack([fmap[mask == i].mean(0) for i in (1, 2, 3)])
    live = np.concatenate([c + rng.normal(size=(80, 16)) * 0.4 for c in centers])
    dead = np.tile(rng.normal(size=(1, 16)), (2000, 1))
    enc = np.concatenate([live, dead]).astype(np.float32)
    opac = np.concatenate([np.full(240, 0.9), np.full(2000, 1e-3)])
    truth = np.repeat([0, 1, 2], 80)

    ref = jclu.kmeans_identity_encodings_background(fmap, mask, enc)["labels"]
    ref[opac < 0.05] = -1
    assert len(set(ref[:240].tolist()) - {-1}) < 3

    got = cluster_live_rows(fmap, mask, torch.from_numpy(enc), opac, device="cpu")
    labels = got["labels"]
    assert labels.shape == (2240,) and (labels[240:] == -1).all()
    for i in range(3):
        kept = labels[:240][(truth == i) & (labels[:240] >= 0)]
        assert len(kept) >= 70 and (kept == i).all()
    assert (labels[:240] == -1).sum() == 12  # the 95th percentile's outliers


def test_dbscan_matches():
    pytest.importorskip("sklearn")
    X, _ = _clusters(7, n_per=40, K=3)
    want = jclu.dbscan_identity_encodings(X, target_clusters=3)
    got = tclu.dbscan_identity_encodings(torch.from_numpy(X), target_clusters=3)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["n_clusters"] == want["n_clusters"] == 3 and got["eps"] == want["eps"]
