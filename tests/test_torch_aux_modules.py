"""Port parity of the trainer's optional modules against the JAX package:
``rotation_6d_to_matrix``, the camera corrector (``apply_camera_opt`` /
``CameraOptModule``) and its regularizer, the appearance module with the
JAX package's weights carried across (``convert.aux_params_from_numpy``:
``w{i}`` transposed into ``nn.Linear``), the bilateral grid's slice and total variation,
``color_correct``, ``morton_sort_centers`` and ``PngCompression``, outputs
and gradients, from numpy seeds.

Tolerances: outputs and gradients max|Δ| ≤ 1e-5 · max|ref| per input;
the compression's decoded arrays at their quantization step (means: one
16-bit step of their log-space span; the 8-bit attributes: half a step,
float rounding of the dequantization aside; shN: equal where the two
K-means give a row the same label, which they do for all but a few rows at
near ties).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.compression import PngCompression as JPng
from tdgs.training import bilateral_grid as jbg
from tdgs.training import modules as jmod
from tdgs.utils.ply import morton_sort_centers as j_morton
from tdgs_torch import convert
from tdgs_torch.compression import PngCompression as TPng
from tdgs_torch.training import bilateral_grid as tbg
from tdgs_torch.training import modules as tmod
from tdgs_torch.utils.ply import morton_sort_centers as t_morton
from tests.test_torch_training import _close_rel

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grads(j_fn, t_fn, inputs, weight, argnums):
    """(outputs, gradients of <out, weight> w.r.t. inputs[argnums]) of both
    packages."""
    def j_loss(*xs):
        out = j_fn(*xs)
        return jnp.sum(out * weight), out

    (_, j_out), j_g = jax.jit(jax.value_and_grad(j_loss, argnums=argnums, has_aux=True))(
        *map(jnp.asarray, inputs))
    ts = [torch.tensor(x, requires_grad=i in argnums) for i, x in enumerate(inputs)]
    t_out = t_fn(*ts)
    t_g = torch.autograd.grad((t_out * torch.from_numpy(weight)).sum(),
                              [ts[i] for i in argnums])
    return (t_out.detach().numpy(), np.asarray(j_out),
            [g.numpy() for g in t_g], [np.asarray(g) for g in j_g])


def test_rotation_6d_to_matrix_matches_jax():
    rng = np.random.default_rng(0)
    d6 = rng.normal(size=(64, 6)).astype(np.float32)
    w = rng.normal(size=(64, 3, 3)).astype(np.float32)
    t_out, j_out, t_g, j_g = _grads(jmod.rotation_6d_to_matrix, tmod.rotation_6d_to_matrix,
                                    [d6], w, (0,))
    _close_rel(t_out, j_out, RTOL, "R")
    _close_rel(t_g[0], j_g[0], RTOL, "v_d6")
    R = t_out
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


@pytest.mark.parametrize("std", [0.0, 0.05])
def test_camera_corrector_matches_jax(std):
    """camtoworlds ∘ exp(delta) for a batch of images, and its gradients to
    the poses and the deltas; the module's zero init is the identity."""
    rng = np.random.default_rng(1)
    n = 6
    embeds = (rng.normal(size=(n, 9)) * 0.05).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    c2w[:, :3, :3] = tmod.rotation_6d_to_matrix(
        torch.from_numpy(rng.normal(size=(3, 6)).astype(np.float32))).numpy()
    c2w[:, :3, 3] = rng.normal(size=(3, 3))
    ids = np.array([4, 0, 4], np.int32)
    w = rng.normal(size=(3, 4, 4)).astype(np.float32)

    def j_fn(e, c):
        return jmod.apply_camera_opt({"embeds": e}, c, jnp.asarray(ids))

    def t_fn(e, c):
        return tmod.apply_camera_opt(e, c, torch.from_numpy(ids))

    t_out, j_out, t_g, j_g = _grads(j_fn, t_fn, [embeds, c2w], w, (0, 1))
    _close_rel(t_out, j_out, RTOL, "c2w")
    for name, a, b in zip(("v_embeds", "v_c2w"), t_g, j_g):
        _close_rel(a, b, RTOL, name)
    np.testing.assert_allclose(tmod.camera_opt_reg(torch.from_numpy(embeds)).item(),
                               float(jmod.camera_opt_reg({"embeds": jnp.asarray(embeds)})),
                               rtol=RTOL)
    module = tmod.CameraOptModule(n, std=std, generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    out = module(torch.from_numpy(c2w), torch.from_numpy(ids)).detach().numpy()
    if std == 0.0:
        np.testing.assert_allclose(out, c2w, atol=1e-6)
    else:
        assert 0.02 < float(module.embeds.detach().std()) < 0.08
        assert np.abs(out - c2w).max() > 1e-3


@pytest.mark.parametrize("sh_degree", [1, 3])
def test_appearance_module_matches_jax(sh_degree):
    """The MLP over [embeds, features, SH bases padded to degree 3] with
    JAX's init_appearance_opt weights (a nonzero last layer, so every input
    reaches the output), for image ids and for eval's None; gradients to
    the features, the directions and every weight."""
    rng = np.random.default_rng(2)
    n_img, N, F, E, C = 5, 40, 8, 4, 2
    params = jmod.init_appearance_opt(jax.random.PRNGKey(3), n_img, F, embed_dim=E,
                                      sh_degree=3)
    params = {k: np.asarray(v) for k, v in params.items()}
    params["w2"] = (rng.normal(size=params["w2"].shape) * 0.2).astype(np.float32)
    params["embeds"] = rng.normal(size=(n_img, E)).astype(np.float32)
    params["b0"] = rng.normal(size=params["b0"].shape).astype(np.float32) * 0.1
    feats = rng.uniform(size=(N, F)).astype(np.float32)
    dirs = rng.normal(size=(C, N, 3)).astype(np.float32)
    w = rng.normal(size=(C, N, 3)).astype(np.float32)

    module = tmod.AppearanceOptModule(n_img, F, embed_dim=E, sh_degree=3, device="cpu")
    assert [tuple(l.weight.shape) for l in module.linears] == [
        tuple(params[f"w{i}"].shape[::-1]) for i in range(3)]
    assert not module.linears[-1].weight.abs().any()  # zero last layer
    jax_aux = {"app_embeds": params["embeds"],
               "app_mlp": {k: v for k, v in params.items() if k != "embeds"}}
    groups = convert.aux_params_from_numpy(jax_aux, device="cpu")
    with torch.no_grad():
        for name, p in module.linears.named_parameters():
            p.copy_(groups["app_mlp"][name])
        module.embeds.copy_(groups["app_embeds"]["embeds"])
    back = convert.aux_params_to_numpy({"app_embeds": {"embeds": module.embeds},
                                        "app_mlp": dict(module.linears.named_parameters())})
    np.testing.assert_array_equal(back["app_embeds"], params["embeds"])
    for k, v in back["app_mlp"].items():
        np.testing.assert_array_equal(v, params[k])

    for ids in (np.array([3, 1], np.int32), None):
        def j_fn(f, d, *ws):
            p = dict(zip(sorted(params), ws))
            return jmod.apply_appearance_opt(p, f, None if ids is None else jnp.asarray(ids),
                                             d, sh_degree)

        def t_fn(f, d, *ws):
            return module(f, None if ids is None else torch.from_numpy(ids), d, sh_degree)

        weights = [params[k] for k in sorted(params)]
        t_out, j_out, t_g, j_g = _grads(j_fn, t_fn, [feats, dirs] + weights, w, (0, 1))
        _close_rel(t_out, j_out, RTOL, f"colors ids={ids}")
        for name, a, b in zip(("v_features", "v_dirs"), t_g, j_g):
            _close_rel(a, b, RTOL, name)

    # every weight's gradient (port: the parameters, JAX: the dict)
    def j_loss(p):
        return jnp.sum(jmod.apply_appearance_opt(p, jnp.asarray(feats), jnp.asarray([3, 1]),
                                                 jnp.asarray(dirs), sh_degree) * w)

    j_g = jax.grad(j_loss)({k: jnp.asarray(v) for k, v in params.items()})
    out = module(torch.from_numpy(feats), torch.tensor([3, 1]), torch.from_numpy(dirs),
                 sh_degree)
    module.zero_grad()
    (out * torch.from_numpy(w)).sum().backward()
    for i, lin in enumerate(module.linears):
        _close_rel(lin.weight.grad.T.numpy(), np.asarray(j_g[f"w{i}"]), RTOL, f"v_w{i}")
        _close_rel(lin.bias.grad.numpy(), np.asarray(j_g[f"b{i}"]), RTOL, f"v_b{i}")
    _close_rel(module.embeds.grad.numpy(), np.asarray(j_g["embeds"]), RTOL, "v_embeds")


def test_bilateral_grid_slice_and_tv_match_jax():
    """The trilinear slice (luma clipped: some colours beyond [0, 1]) of
    perturbed grids, its gradients to the grids and the colours, and the
    total variation."""
    rng = np.random.default_rng(4)
    n, gh, gw, gg = 3, 5, 6, 4
    grids = np.asarray(jbg.init_bilateral_grid(n, gw, gh, gg))
    t_grids = tbg.init_bilateral_grid(n, gw, gh, gg, device="cpu").numpy()
    np.testing.assert_array_equal(t_grids, grids)
    assert grids.shape == (n, gh, gw, gg, 12)
    grids = (grids + rng.normal(size=grids.shape) * 0.1).astype(np.float32)
    rgb = rng.uniform(-0.1, 1.1, size=(2, 20, 28, 3)).astype(np.float32)
    ids = np.array([2, 0], np.int32)
    w = rng.normal(size=rgb.shape).astype(np.float32)

    def j_fn(g, c):
        return jbg.bilateral_grid_slice(g, jnp.asarray(ids), c)

    def t_fn(g, c):
        return tbg.bilateral_grid_slice(g, torch.from_numpy(ids), c)

    t_out, j_out, t_g, j_g = _grads(j_fn, t_fn, [grids, rgb], w, (0, 1))
    _close_rel(t_out, j_out, RTOL, "sliced")
    for name, a, b in zip(("v_grids", "v_rgb"), t_g, j_g):
        _close_rel(a, b, RTOL, name)
    tg = torch.tensor(grids, requires_grad=True)
    tv = tbg.total_variation_loss(tg)
    (v_tv,) = torch.autograd.grad(tv, tg)
    j_tv, j_vtv = jax.value_and_grad(jbg.total_variation_loss)(jnp.asarray(grids))
    np.testing.assert_allclose(tv.item(), float(j_tv), rtol=RTOL)
    _close_rel(v_tv.numpy(), np.asarray(j_vtv), RTOL, "v_tv")
    # identity grids leave the colours as they are
    ident = tbg.init_bilateral_grid(n, gw, gh, gg, device="cpu")
    np.testing.assert_allclose(tbg.bilateral_grid_slice(ident, torch.from_numpy(ids),
                                                        torch.from_numpy(rgb)).numpy(),
                               rgb, atol=1e-6)


def test_color_correct_matches_jax():
    """The affine least-squares fit of a colour-shifted prediction, against
    JAX's: the fit recovers the affine, and a prediction already equal to
    the reference comes back unchanged."""
    rng = np.random.default_rng(5)
    ref = rng.uniform(0.05, 0.95, size=(24, 32, 3)).astype(np.float32)
    A = np.array([[0.8, 0.1, 0.0], [0.05, 0.9, 0.1], [0.0, 0.05, 0.7]], np.float32)
    img = np.clip(ref @ A.T + [0.05, -0.02, 0.1], 0, 1).astype(np.float32)
    got = tbg.color_correct(torch.from_numpy(img), torch.from_numpy(ref)).numpy()
    want = np.asarray(jbg.color_correct(jnp.asarray(img), jnp.asarray(ref)))
    _close_rel(got, want, RTOL, "cc")
    assert np.abs(got - ref).max() < 0.02 < np.abs(img - ref).max()
    same = tbg.color_correct(torch.from_numpy(ref), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(same, ref, atol=1e-4)


def test_morton_sort_centers_matches_jax():
    rng = np.random.default_rng(6)
    means = rng.normal(size=(500, 3)).astype(np.float32)
    means[100:110] = means[0]  # ties
    np.testing.assert_array_equal(t_morton(means), j_morton(means))


def _splats(seed, n, K=16, extras=True):
    rng = np.random.default_rng(seed)
    s = {"means": rng.normal(size=(n, 3)).astype(np.float32) * 3,
         "scales": rng.uniform(-5, -1, size=(n, 3)).astype(np.float32),
         "quats": rng.normal(size=(n, 4)).astype(np.float32),
         "opacities": rng.normal(size=(n,)).astype(np.float32),
         "sh0": rng.normal(size=(n, 1, 3)).astype(np.float32),
         "shN": rng.normal(size=(n, K - 1, 3)).astype(np.float32) * 0.2}
    if extras:
        s["features"] = rng.uniform(size=(n, 8)).astype(np.float32)
        s["colors"] = rng.normal(size=(n, 3)).astype(np.float32)
    return s


@pytest.mark.parametrize("n,K", [(410, 16), (100, 1)])
def test_png_compression_matches_jax(tmp_path, n, K):
    """Both packages compress the same splats (cropped to 400 = 20², Morton
    order, a codebook of 64 for shN; at SH degree 0 no codebook) and each
    decompresses its own: the decoded arrays agree at their quantization
    steps, and each package reads the other's files."""
    splats = _splats(7, n, K)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    JPng(n_clusters=64).compress(jd, splats)
    TPng(n_clusters=64, device="cpu").compress(td, splats)
    want = JPng().decompress(jd)
    got = TPng(device="cpu").decompress(td)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    side = int(np.sqrt(n))
    keep = np.argsort(splats["opacities"])[n - side * side:]
    order = j_morton(splats["means"][keep])
    orig = {k: v[keep][order] for k, v in splats.items()}
    # means: one 16-bit step of the log-space span, in log space
    lg = np.sign(orig["means"]) * np.log1p(np.abs(orig["means"]))
    step = (lg.max(0) - lg.min(0)) / 65535
    for dec in (got, want):
        dl = np.sign(dec["means"]) * np.log1p(np.abs(dec["means"]))
        assert (np.abs(dl - lg) <= step * 1.01).all()
    np.testing.assert_allclose(got["means"], want["means"], rtol=0, atol=1e-6)
    for k in ("scales", "quats", "opacities", "sh0"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        span = orig[k].reshape(side * side, -1).max(0) - orig[k].reshape(side * side, -1).min(0)
        err = np.abs(got[k] - orig[k]).reshape(side * side, -1)
        assert (err <= span / 255 * 0.5 + 1e-6).all(), k
    for k in ("features", "colors"):
        np.testing.assert_array_equal(got[k], orig[k])
    if K > 1:
        with np.load(os.path.join(td, "shN.npz")) as zt, np.load(os.path.join(jd, "shN.npz")) as zj:
            same = zt["labels"] == zj["labels"]
        assert same.mean() >= 0.98, same.mean()
        rows_t = got["shN"].reshape(side * side, -1)
        rows_j = want["shN"].reshape(side * side, -1)
        # float16 centroids: 1e-3 relative
        np.testing.assert_allclose(rows_t[same], rows_j[same], rtol=2e-3, atol=2e-4)
    else:
        assert got["shN"].shape == (side * side, 0, 3)
    # each package decodes the other's files
    for a, b in ((TPng(device="cpu").decompress(jd), want), (JPng().decompress(td), got)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_create_splats_features_and_strategies_carry_them():
    """create_splats(feature_dim) adds ``features`` (uniform) and ``colors``
    (the logit of the clipped colours) as the JAX package's does, padded
    with dead rows; the DefaultStrategy's duplicate and split and the MCMC
    relocation copy both into the rows they fill."""
    from tdgs.models import gaussians as jg
    from tdgs_torch.models import gaussians as tg
    from tdgs_torch.ops.relocation import make_binoms
    from tdgs_torch.strategy import ops as tops

    rng = np.random.default_rng(8)
    pts = rng.normal(size=(60, 3)).astype(np.float32)
    rgbs = rng.uniform(size=(60, 3)).astype(np.float32)
    rgbs[0] = [0.0, 1.0, 0.5]  # clipped to [1e-4, 1 - 1e-4]
    t = tg.create_splats(torch.from_numpy(pts), torch.from_numpy(rgbs),
                         torch.Generator().manual_seed(0), sh_degree=1, n_max=128,
                         feature_dim=8)
    j = jg.create_splats(jnp.asarray(pts), jnp.asarray(rgbs), jax.random.PRNGKey(0),
                         sh_degree=1, n_max=128, feature_dim=8)
    assert set(t) == set(j)
    for k in j:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
    _close_rel(t["colors"].numpy(), np.asarray(j["colors"]), RTOL, "colors")
    f = t["features"][:60]
    assert float(f.min()) >= 0.0 and float(f.max()) < 1.0 and float(f.std()) > 0.2
    assert not t["features"][60:].abs().any()

    opt = {part: {k: torch.zeros_like(v) for k, v in t.items()} for part in ("mu", "nu")}
    grad2d = torch.zeros(128)
    grad2d[:6] = 1.0  # six high-gradient parents: small ones duplicate
    out, _, info = tops.grow_and_prune_default(
        t, opt, torch.Generator().manual_seed(1), grad2d, torch.ones(128), torch.zeros(128),
        scene_scale=1e4)
    assert int(info["n_dupli"]) == 6 and int(info["n_granted"]) == 6
    for k in ("features", "colors"):
        filled = out[k][60:66]
        assert torch.equal(filled.sort(0).values, t[k][:6].sort(0).values), k
    sampled = torch.arange(128) % 60  # rows 60..127 copy rows 0..67 mod 60
    out, _, _ = tops.refine_mcmc(t, opt, sampled, n_before=60, n_target=100,
                                 binoms=make_binoms(device="cpu"))
    for k in ("features", "colors"):
        assert torch.equal(out[k][60:100], t[k][sampled[60:100]]), k
