"""Selective Adam over every parameter group at once (``ops/adam.py``
``adam_update``), on the CPU and on the card.

On the CPU the wrapper takes its plain version, which must equal, bit for
bit, the chain ``SplatOptimizer.update`` ran group by group before the
kernel (``_chain_update`` below): per-group learning rates, with and without
a visibility mask, at the trainer's group shapes (an empty ``shN`` at SH
degree 0 included), its inputs left untouched.

On the card (marked ``cuda``; the file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed)

    python -m pytest --noconftest -m cuda tests/test_torch_adam.py

the kernel (``csrc/adam.cu``) against the plain version at 1M rows of the
six 3DGS groups with a random mask: visible elements within 4 float32 ulps
of the plain version's, and of the parameter's step (the kernel rounds each
operation on its own, in the plain version's order, with an IEEE square
root and division; PyTorch's own kernels need not round so: on a CPU its
square root was seen an ulp off), masked rows bitwise equal to the inputs,
the inputs untouched, gradients that are slices of one (the SH groups') read
where they lie, one launch a call (the functional ``selective_adam`` too),
and the wrapper refusing float64, a non-contiguous parameter or moment, a
gradient whose rows are not each contiguous and a second device.
"""

import pytest
import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops.adam import (
    _rows_contiguous,
    adam_update,
    adam_update_plain,
    selective_adam,
    selective_adam_step,
)
from tdgs_torch.training.config import Config
from tdgs_torch.training.trainer import SplatOptimizer

B1, B2, EPS = 0.9, 0.999, 1e-15
# the trainer's groups at SH degree 3, and shN at degree 0
SHAPES = {"means": (3,), "scales": (3,), "quats": (4,), "opacities": (), "sh0": (1, 3),
          "shN": (15, 3)}
LRS = {"means": 1.6e-4, "scales": 5e-3, "quats": 1e-3, "opacities": 5e-2, "sh0": 2.5e-3,
       "shN": 2.5e-3 / 20}


def _chain_update(grads, state, params, lr_dict, visibility=None, b1=B1, b2=B2, eps=EPS):
    """``SplatOptimizer.update`` as it ran before the kernel: per group the
    moments, the two masks over them, the step, its mask and ``p + step``."""
    new_mu, new_nu, new_params = {}, {}, {}
    for name, g in grads.items():
        m, v = state["mu"][name], state["nu"][name]
        mu = b1 * m + (1.0 - b1) * g
        nu = b2 * v + (1.0 - b2) * g * g
        if visibility is not None:
            vis = visibility.reshape(visibility.shape + (1,) * (g.dim() - 1))
            mu, nu = torch.where(vis, mu, m), torch.where(vis, nu, v)
        step = -lr_dict[name] * mu / (torch.sqrt(nu) + eps)
        if visibility is not None:
            step = torch.where(vis, step, torch.zeros_like(step))
        new_mu[name], new_nu[name] = mu, nu
        new_params[name] = params[name] + step
    return new_params, {"mu": new_mu, "nu": new_nu}


def _case(n, shapes=SHAPES, seed=0, device="cpu", visible=0.7, sh_slices=False):
    """Parameters, gradients and moments (the second moment positive, as
    Adam leaves it) of the groups in ``shapes`` at ``n`` rows, and a mask.
    With ``sh_slices`` the gradients of sh0 and shN are slices of one
    [n, 16, 3] tensor, as the backward of their concatenation leaves them."""
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, scale=1.0):
        return (torch.randn((n,) + shape, generator=gen) * scale).to(device)

    params = {k: draw(s) for k, s in shapes.items()}
    grads = {k: draw(s, 1e-3) for k, s in shapes.items()}
    if sh_slices:
        sh = draw((16, 3), 1e-3)
        grads.update(sh0=sh[:, :1], shN=sh[:, 1:])
    mu = {k: draw(s, 1e-4) for k, s in shapes.items()}
    nu = {k: draw(s, 1e-4).square() for k, s in shapes.items()}
    vis = (torch.rand(n, generator=gen) < visible).to(device)
    return params, grads, mu, nu, vis


def _snapshot(*trees):
    return [{k: v.clone() for k, v in t.items()} for t in trees]


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sh_degree", [0, 3])
def test_plain_equals_the_chain_bitwise(masked, sh_degree):
    shapes = dict(SHAPES, shN=(0, 3) if sh_degree == 0 else (15, 3))
    params, grads, mu, nu, vis = _case(257, shapes, seed=sh_degree + 2 * masked,
                                       sh_slices=sh_degree == 3)
    visibility = vis if masked else None
    before = _snapshot(params, grads, mu, nu)
    got_p, got_m, got_v = adam_update(params, grads, mu, nu, LRS, B1, B2, EPS, visibility)
    want_p, want_state = _chain_update(grads, {"mu": mu, "nu": nu}, params, LRS, visibility)
    _assert_same(got_p, want_p)
    _assert_same(got_m, want_state["mu"])
    _assert_same(got_v, want_state["nu"])
    for tree, old in zip((params, grads, mu, nu), before):
        _assert_same(tree, old)  # the inputs are untouched
    if masked:
        for k in shapes:
            hidden = ~vis
            assert torch.equal(got_p[k][hidden], params[k][hidden]), k
            assert torch.equal(got_m[k][hidden], mu[k][hidden]), k
            assert torch.equal(got_v[k][hidden], nu[k][hidden]), k


@pytest.mark.parametrize("masked", [False, True])
def test_splat_optimizer_update_equals_the_chain(masked):
    """The trainer's update over the wrapper, two steps chained, at the
    learning rates of its schedules."""
    opt = SplatOptimizer(Config(), scene_scale=2.0, max_steps=100)
    params, _, _, _, vis = _case(100, seed=7)
    state = opt.init(params)
    want_params, want_state = params, opt.init(params)
    gen = torch.Generator().manual_seed(8)
    for step in range(2):
        grads = {k: torch.randn(v.shape, generator=gen) * 1e-3 for k, v in params.items()}
        lr = {k: v for k, v in opt.lr_at(step).items() if k in params}
        visibility = vis if masked else None
        params, state = opt.update(grads, state, params, lr, visibility=visibility)
        want_params, want_state = _chain_update(grads, want_state, want_params, lr,
                                                visibility)
        _assert_same(params, want_params)
        _assert_same(state["mu"], want_state["mu"])
        _assert_same(state["nu"], want_state["nu"])


def test_rows_contiguous():
    """The gradients the kernel reads where they lie, and those it refuses."""
    sh = torch.zeros(5, 16, 3)
    assert _rows_contiguous(sh[:, 1:]) and _rows_contiguous(sh[:, :1])
    assert not sh[:, 1:].is_contiguous()
    assert not _rows_contiguous(sh.transpose(1, 2)[:, :, 1:])
    assert not _rows_contiguous(torch.zeros(1, 3).expand(5, 3))  # the rows overlap
    assert _rows_contiguous(torch.zeros(5)) and _rows_contiguous(torch.zeros(1, 3).expand(1, 3))


def test_wrapper_checks_the_mask():
    params, grads, mu, nu, vis = _case(16)
    with pytest.raises(ValueError, match="rows"):
        adam_update(params, grads, mu, nu, LRS, B1, B2, EPS, vis[:-1])
    with pytest.raises(TypeError, match="bool"):
        adam_update(params, grads, mu, nu, LRS, B1, B2, EPS, vis.float())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _spacing(x):
    return torch.nextafter(x.abs(), torch.full_like(x, float("inf"))) - x.abs()


def _within_ulps(a, b, step=None, n_ulps=4):
    """|a − b| within ``n_ulps`` float32 ulps of b, and of the ``step`` that
    made b where there is one: a parameter's step can be far larger than
    the parameter, and an ulp of the step is then many of the result."""
    room = _spacing(b) + (0 if step is None else _spacing(step))
    return bool(((a - b).abs() <= n_ulps * room).all())


def _check_against_plain(inputs, lrs, visibility):
    params, grads, mu, nu = inputs
    before = _snapshot(*inputs)
    n0 = _build.LAUNCHES.get("adam", 0)
    got = adam_update(params, grads, mu, nu, lrs, B1, B2, EPS, visibility)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["adam"] == n0 + 1
    want = adam_update_plain(params, grads, mu, nu, lrs, B1, B2, EPS, visibility)
    for tree, old in zip(inputs, before):
        _assert_same(tree, old)  # the inputs are untouched
    for k in grads:
        for j, (out, ref, src) in enumerate(zip(got, want, (params, mu, nu))):
            assert out[k].shape == src[k].shape and out[k].is_contiguous(), k
            shown = slice(None) if visibility is None else visibility
            step = ref[k][shown] - src[k][shown] if j == 0 else None
            assert _within_ulps(out[k][shown], ref[k][shown], step), k
            if visibility is not None:
                assert torch.equal(out[k][~shown], src[k][~shown]), k


@pytest.mark.cuda
@pytest.mark.parametrize("sh_slices", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, masked, sh_slices):
    params, grads, mu, nu, vis = _case(1_000_000, device=cuda_device, seed=11,
                                       sh_slices=sh_slices)
    _check_against_plain((params, grads, mu, nu), LRS, vis if masked else None)


@pytest.mark.cuda
def test_kernel_unaligned_and_empty_groups_on_card(cuda_device):
    """Groups whose arrays start off a 16-byte boundary (the scalar path),
    rows of one float, an empty group, and sizes that leave a partial chunk
    and a partial float4."""
    n = 5003
    shapes = {"odd": (3,), "one": (), "empty": (0, 3), "wide": (45,)}
    params, grads, mu, nu, vis = _case(n + 1, shapes, device=cuda_device, seed=12)
    # a view one row in: off 16 bytes for every width but a multiple of 4
    shifted = [{k: t[1:] for k, t in tree.items()} for tree in (params, grads, mu, nu)]
    lrs = {k: 1e-2 * (i + 1) for i, k in enumerate(shapes)}
    for tree in shifted:
        for k in ("odd", "one", "wide"):
            assert tree[k].data_ptr() % 16 != 0 and tree[k].is_contiguous(), k
    _check_against_plain(tuple(shifted), lrs, vis[1:])
    _check_against_plain((params, grads, mu, nu), lrs, vis)


@pytest.mark.cuda
def test_functional_selective_adam_on_card(cuda_device):
    """The functional transformation takes its steps from the kernel: one
    launch an update, its steps and moments within ulps of the plain
    per-group step, masked rows' steps zero and moments kept."""
    _, grads, mu, nu, vis = _case(5000, device=cuda_device, seed=15, sh_slices=True)
    init, update = selective_adam(1e-2, B1, B2, EPS)
    state = init(grads)._replace(exp_avg=mu, exp_avg_sq=nu)
    n0 = _build.LAUNCHES.get("adam", 0)
    steps, new = update(grads, state, visibility=vis)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["adam"] == n0 + 1 and new.count == 1
    for k, g in grads.items():
        step, m, v = selective_adam_step(g, mu[k], nu[k], 1e-2, B1, B2, EPS, vis)
        assert _within_ulps(steps[k], step) and _within_ulps(new.exp_avg[k], m), k
        assert _within_ulps(new.exp_avg_sq[k], v), k
        assert not steps[k][~vis].any(), k
        assert torch.equal(new.exp_avg[k][~vis], mu[k][~vis]), k


@pytest.mark.cuda
def test_splat_optimizer_one_launch_a_step_on_card(cuda_device):
    opt = SplatOptimizer(Config(), scene_scale=2.0, max_steps=100)
    params, grads, _, _, vis = _case(10_000, device=cuda_device, seed=13)
    state = opt.init(params)
    lr = {k: v for k, v in opt.lr_at(0).items() if k in params}
    n0 = _build.LAUNCHES.get("adam", 0)
    for i in range(3):
        params, state = opt.update(grads, state, params, lr, visibility=vis)
        assert _build.LAUNCHES["adam"] == n0 + i + 1


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda_device):
    params, grads, mu, nu, vis = _case(64, device=cuda_device, seed=14)
    bad = dict(grads, means=grads["means"].double())
    with pytest.raises(TypeError, match="float32"):
        adam_update(params, bad, mu, nu, LRS, B1, B2, EPS, vis)
    bad = dict(params, quats=params["quats"].t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        adam_update(bad, grads, mu, nu, LRS, B1, B2, EPS, vis)
    sh = torch.zeros(64, 16, 3, device=cuda_device)
    bad = dict(nu, shN=sh[:, 1:])  # rows apart: read so in a gradient only
    with pytest.raises(ValueError, match="contiguous"):
        adam_update(params, grads, mu, bad, LRS, B1, B2, EPS, vis)
    bad = dict(grads, quats=grads["quats"].t().contiguous().t())  # a row's floats apart
    assert not _rows_contiguous(bad["quats"])
    with pytest.raises(ValueError, match="contiguous row by row"):
        adam_update(params, bad, mu, nu, LRS, B1, B2, EPS, vis)
    bad = dict(mu, scales=mu["scales"].cpu())
    with pytest.raises(ValueError, match="device"):
        adam_update(params, grads, bad, nu, LRS, B1, B2, EPS, vis)
    with pytest.raises(ValueError, match="device"):
        adam_update(params, grads, mu, nu, LRS, B1, B2, EPS, vis.cpu())
