"""The 2DGS surfel projection's Function and kernels (``ops/projection_2dgs.py``,
``csrc/surfel_project.cu``), on the CPU and on the card.

On the CPU the Function takes the plain versions: its forward is the
differentiable chain (``surfel_projection_chain``), its backward the
chain's closed-form VJP (``surfel_projection_vjp_plain``). The VJP must
equal autograd of the chain over float64 inputs (``VJP_RTOL`` of each row's
largest gradient), on ``card_scenes.surfel_scene``'s rows (behind the
camera, at the near plane, off the image, large, degenerate, in the camera's
plane where d = 0, normals turned both ways) with one camera, three, batch
dimensions [2, 3], the clip planes and eps, and with any cotangent left out.
``fully_fused_projection_2dgs`` routes by its inputs: where ``viewmats`` or
``Ks`` require a gradient, the chain, which gives the cameras theirs; every
other call the Function.

On the card (marked ``cuda``; the file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed)

    python -m pytest --noconftest -m cuda tests/test_torch_surfel_project.py

the forward kernel equals the chain and the backward kernel the plain VJP
bit for bit (the kernels repeat their float32 operations in order, built
without fused multiply-adds), and two launches equal each other, at 20k
rows with one camera and three, at the 2DGS cell's 3M rows at 1297x840
with one camera and three, with batch dimensions, unaligned rows and no
rows; a render with a pose gradient launches neither kernel, one without
launches each once; the wrappers refuse what they do not take.
"""

import pytest
import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops import projection_2dgs as P
from tests import card_scenes as C

VJP_RTOL = 1e-9  # float64: max|Δ| of a row's gradient ÷ its largest |gradient|
COTANGENTS = ("means2d", "depths", "M", "normals")

# name → (batch dimensions, cameras, projection options)
CASES = {
    "one_camera": ((), 1, {}),
    "three_cameras": ((), 3, {}),
    "batch_2x3": ((2,), 3, {}),
    "clip_planes_eps": ((), 2, dict(near_plane=0.02, far_plane=9.0, radius_clip=2.0, eps=1e-3)),
}
# name → the cotangents given (the others None)
GIVEN = {
    "all": COTANGENTS,
    "means2d": ("means2d",),
    "M_normals": ("M", "normals"),
}


def case_inputs(name, n, seed=0, device="cpu", dtype=torch.float32):
    """(means, quats, scales, viewmats, Ks) of ``CASES[name]`` on
    ``surfel_scene``'s rows (a second batch entry: other rows, the cameras
    in the other order), the group of each row, and the options."""
    batch, n_cams, kw = CASES[name]
    sc = C.surfel_scene(n, n_cams, seed, device, dtype)
    keys = ("means", "quats", "scales", "viewmats", "Ks")
    ins = tuple(sc[k] for k in keys)
    if batch:
        other = C.surfel_scene(n, n_cams, seed + 1, device, dtype)
        ins = tuple(torch.stack([a, other[k] if i < 3 else a.flip(0)])
                    for i, (k, a) in enumerate(zip(keys, ins)))
    return ins, sc["group"], kw


def cotangents(outs, given, seed=1):
    gen = torch.Generator(device=outs[1].device).manual_seed(seed)
    return [torch.randn(o.shape, generator=gen, dtype=o.dtype, device=o.device)
            if name in given else None for name, o in zip(COTANGENTS, outs[1:])]


def _rows_close(got, want, rows_dims):
    """max|Δ| over each row's entries ÷ the row's largest |want|."""
    d = (got - want).abs().flatten(rows_dims).amax(-1)
    scale = want.abs().flatten(rows_dims).amax(-1)
    return float(torch.where(d == 0, torch.zeros_like(d), d / scale).max())


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("given", list(GIVEN))
@pytest.mark.parametrize("name", list(CASES))
def test_plain_vjp_matches_autograd_of_the_chain(name, given):
    ins, group, kw = case_inputs(name, 600, seed=len(name), dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in ins[:3]]
    outs = P.surfel_projection_chain(*leaves, *ins[3:], C.SURFEL_WIDTH, C.SURFEL_HEIGHT, **kw)
    cots = cotangents(outs, GIVEN[given])
    pairs = [(o, c) for o, c in zip(outs[1:], cots) if c is not None]
    want = torch.autograd.grad([o for o, _ in pairs], leaves, [c for _, c in pairs],
                               allow_unused=True)
    got = P.surfel_projection_vjp_plain(*ins, *cots, eps=kw.get("eps", 0.0))
    for what, g, w in zip(("means", "quats", "scales"), got, want):
        w = torch.zeros_like(g) if w is None else w
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), what
        assert _rows_close(g, w, -1) <= VJP_RTOL, (what, _rows_close(g, w, -1))
    assert bool((got[2][..., 2] == 0).all())  # the third scale is not read

    # the scene's rows: every group, both flips, d = 0, culled and kept rows
    g = P._geometry(*ins, kw.get("eps", 0.0))
    assert set(group.tolist()) == set(range(len(C.SURFEL_GROUPS)))
    kept = (outs[0] > 0).any(-1)
    assert bool(kept.any()) and bool((~kept).any())
    flips = g.flip.expand(kept.shape)[kept]
    assert bool((flips > 0).any()) and bool((flips < 0).any())
    plane = group == C.SURFEL_GROUPS.index("camera_plane")
    d_zero = ((g.rcp == 1) & ~g.big).reshape(-1, *g.rcp.shape[-2:])
    assert bool(d_zero[0, 0, plane].all())  # the first batch entry's first camera


def test_cpu_function_takes_the_plain_versions():
    """Outputs the chain's, gradients the plain VJP's, bit for bit, through
    the Function (``radii`` not differentiable); no launch counted."""
    ins, _, _ = case_inputs("three_cameras", 500, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in ins[:3]]
    n0 = {k: _build.LAUNCHES.get(k, 0) for k in (P.KERNEL, P.KERNEL_BWD)}
    outs = P.fully_fused_projection_2dgs(*leaves, *ins[3:], C.SURFEL_WIDTH, C.SURFEL_HEIGHT)
    assert type(outs[1].grad_fn).__name__ == "_SurfelProjectionBackward"
    assert not outs[0].requires_grad
    want = P.surfel_projection_chain(*ins, C.SURFEL_WIDTH, C.SURFEL_HEIGHT)
    assert all(torch.equal(o, w) for o, w in zip(outs, want))
    cots = cotangents(outs, COTANGENTS)
    got = torch.autograd.grad(outs[1:], leaves, cots)
    plain = P.surfel_projection_vjp_plain(*ins, *cots)
    assert all(torch.equal(g, w) for g, w in zip(got, plain))
    assert {k: _build.LAUNCHES.get(k, 0) for k in n0} == n0


@pytest.mark.parametrize("camera", ["viewmats", "Ks"])
def test_pose_gradient_keeps_the_chain(camera):
    """A camera that requires a gradient (pose optimisation) takes the
    chain: its outputs equal the Function's, the camera gets a finite,
    non-zero gradient, and the surfels get the Function's gradients (to
    float64 rounding: autograd sums in another order)."""
    ins, _, _ = case_inputs("three_cameras", 500, seed=4, dtype=torch.float64)
    cams = {"viewmats": ins[3], "Ks": ins[4]}
    cams[camera] = cams[camera].clone().requires_grad_(True)
    leaves = [t.clone().requires_grad_(True) for t in ins[:3]]
    outs = P.fully_fused_projection_2dgs(*leaves, cams["viewmats"], cams["Ks"],
                                         C.SURFEL_WIDTH, C.SURFEL_HEIGHT)
    assert type(outs[1].grad_fn).__name__ != "_SurfelProjectionBackward"
    plain = P.fully_fused_projection_2dgs(*ins, C.SURFEL_WIDTH, C.SURFEL_HEIGHT)
    assert all(torch.equal(o.detach(), w) for o, w in zip(outs, plain))
    cots = cotangents(outs, COTANGENTS)
    got = torch.autograd.grad(outs[1:], leaves + [cams[camera]], cots)
    assert bool(torch.isfinite(got[3]).all()) and bool((got[3] != 0).any())
    for g, w in zip(got[:3], P.surfel_projection_vjp_plain(*ins, *cots)):
        assert _rows_close(g, w, -1) <= VJP_RTOL


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _launches():
    return {k: _build.LAUNCHES.get(k, 0) for k in (P.KERNEL, P.KERNEL_BWD)}


def _assert_kernels_equal_plain(ins, kw, given=COTANGENTS):
    """Forward: one launch, the chain's outputs bit for bit; backward: one
    launch, the plain VJP's gradients bit for bit; a second launch of each
    the same bits."""
    args = ins + (C.SURFEL_WIDTH, C.SURFEL_HEIGHT)
    n0 = _launches()
    got = P.surfel_project_fwd(*args, **kw)
    again = P.surfel_project_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert _launches()[P.KERNEL] == n0[P.KERNEL] + 2
    want = P.surfel_projection_chain(*args, **kw)
    for what, g, a, w in zip(("radii", "means2d", "depths", "M", "normals"), got, again, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous(), what
        assert not g.requires_grad
        assert torch.equal(g, a), what
        bad = g != w
        assert not bool(bad.any()), (what, int(bad.sum()), g[bad][:4].tolist(), w[bad][:4].tolist())
    cots = cotangents(want, given)
    eps = kw.get("eps", 0.0)
    grads = P.surfel_project_bwd(*ins, *cots, eps=eps)
    again = P.surfel_project_bwd(*ins, *cots, eps=eps)
    torch.cuda.synchronize()
    assert _launches()[P.KERNEL_BWD] == n0[P.KERNEL_BWD] + 2
    plain = P.surfel_projection_vjp_plain(*ins, *cots, eps=eps)
    for what, g, a, w in zip(("means", "quats", "scales"), grads, again, plain):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        assert torch.equal(g, a), what
        bad = g != w
        assert not bool(bad.any()), (what, int(bad.sum()), g[bad][:4].tolist(), w[bad][:4].tolist())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("given", list(GIVEN))
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_equal_the_plain_versions_on_card(card, name, given):
    ins, _, kw = case_inputs(name, 20_000, seed=len(name), device=card)
    _assert_kernels_equal_plain(ins, kw, GIVEN[given])


@pytest.mark.cuda
@pytest.mark.parametrize("n_cams", [1, 3])
def test_kernels_at_full_size_on_card(card, n_cams):
    """The 2DGS cell's shape: 3M surfels at 1297x840, one camera (the
    trainer's) and three."""
    sc = C.surfel_scene(3_000_000, n_cams, seed=7, device=card)
    ins = tuple(sc[k] for k in ("means", "quats", "scales", "viewmats", "Ks"))
    radii = _assert_kernels_equal_plain(ins, {})[0]
    kept = (radii[0] > 0).any(-1)
    for culled in ("behind", "off_image", "camera_plane"):
        assert not bool(kept[sc["group"] == C.SURFEL_GROUPS.index(culled)].any()), culled


@pytest.mark.cuda
def test_kernels_unaligned_rows_and_no_rows_on_card(card):
    """Rows one row into larger arrays with N not a multiple of the block,
    the quaternions one float into theirs (off a 16-byte boundary: the
    scalar loads); no rows at all."""
    ins, _, _ = case_inputs("batch_2x3", 5001, seed=5, device=card)
    shifted = [a[:, 1:] if i < 3 else a for i, a in enumerate(ins)]
    quats = torch.empty(shifted[1].numel() + 1, device=card)[1:].view(shifted[1].shape)
    shifted[1] = quats.copy_(shifted[1])
    assert shifted[1].data_ptr() % 16 != 0 and shifted[1].is_contiguous()
    _assert_kernels_equal_plain(tuple(shifted), {})
    empty = tuple(a[:, :0] if i < 3 else a for i, a in enumerate(ins))
    outs = P.surfel_project_fwd(*empty, C.SURFEL_WIDTH, C.SURFEL_HEIGHT)
    assert outs[0].shape == (2, 3, 0, 2) and outs[3].shape == (2, 3, 0, 3, 3)
    grads = P.surfel_project_bwd(*empty, *cotangents(outs, COTANGENTS))
    assert [g.shape for g in grads] == [a.shape for a in empty[:3]]


@pytest.mark.cuda
@pytest.mark.parametrize("pose", [False, True])
def test_routing_on_card(card, pose):
    """Through ``fully_fused_projection_2dgs``: without a pose gradient one
    launch of each kernel, gradients the backward kernel's; with
    ``viewmats.requires_grad`` neither kernel, and the cameras get their
    gradient."""
    ins, _, _ = case_inputs("one_camera", 20_000, seed=6, device=card)
    viewmats = ins[3].clone().requires_grad_(pose)
    leaves = [t.clone().requires_grad_(True) for t in ins[:3]]
    n0 = _launches()
    outs = P.fully_fused_projection_2dgs(*leaves, viewmats, ins[4], C.SURFEL_WIDTH,
                                         C.SURFEL_HEIGHT)
    cots = cotangents(outs, COTANGENTS)
    torch.autograd.backward(outs[1:], cots)
    torch.cuda.synchronize()
    n = {k: v - n0[k] for k, v in _launches().items()}
    if pose:
        assert n == {P.KERNEL: 0, P.KERNEL_BWD: 0}
        assert bool(torch.isfinite(viewmats.grad).all()) and bool((viewmats.grad != 0).any())
    else:
        assert n == {P.KERNEL: 1, P.KERNEL_BWD: 1}
        want = P.surfel_project_bwd(*ins, *cots)
        assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs_on_card(card):
    ins, _, _ = case_inputs("one_camera", 64, seed=8, device=card)

    def with_(i, x):
        return tuple(x if j == i else a for j, a in enumerate(ins))

    bad = [
        (with_(0, ins[0].double()), "float32"),
        (with_(3, ins[3].double()), "float32"),
        (with_(2, ins[2].cpu()), "device"),
        (with_(4, ins[4].cpu()), "device"),
        (with_(1, ins[1][:-1]), "shape"),
        (with_(2, ins[2][:, :1]), "shape"),
        (with_(3, ins[3][None]), "shape"),
        (with_(3, torch.eye(4, device=card).expand(P.MAX_GRID_Y + 1, 4, 4)), "cameras"),
    ]
    for a, match in bad:
        if match == "cameras":
            a = a[:3] + (a[3], a[4].expand(P.MAX_GRID_Y + 1, 3, 3))
        with pytest.raises(ValueError, match=match):
            P.surfel_project_fwd(*a, C.SURFEL_WIDTH, C.SURFEL_HEIGHT)
        with pytest.raises(ValueError, match=match):
            P.surfel_project_bwd(*a, None, None, None, None)
    outs = P.surfel_project_fwd(*ins, C.SURFEL_WIDTH, C.SURFEL_HEIGHT)
    cots = cotangents(outs, COTANGENTS)
    for i, c in enumerate(cots):
        for wrong in (c.double(), c[..., :-1] if c.dim() > 2 else c[:, :-1], c.cpu()):
            args = list(cots)
            args[i] = wrong
            with pytest.raises(ValueError, match=COTANGENTS[i]):
                P.surfel_project_bwd(*ins, *args)
    with pytest.raises(ValueError, match="device"):
        P.surfel_project_fwd(*(t.cpu() for t in ins), C.SURFEL_WIDTH, C.SURFEL_HEIGHT)
