"""The plain reference against the system's CPU path (its plain versions)
at small shapes: the render and the gradients of every raw parameter."""

import pytest
import torch

import tdgs_torch
from portbench.reference import render as R
from portbench.reference import train as T
from portbench.scenes import rich
from portbench.scenes.state import trained_state

SPEC = {"surface_jitter": 0.2, "log_scale_sd": 0.35, "flatness": 0.3, "big_share": 0.05,
        "big_mult": 2.5, "dead_share": 0.05, "shn_sd": 0.05}
W, H = 48, 32


def _scene(n, seed, view):
    st = trained_state(n, seed, "cpu", SPEC)
    vms, K = rich.cameras(8, W, H)
    return st, torch.as_tensor(vms[view]), torch.as_tensor(K)


def _port(params, vm, K, bg=None):
    means, quats = params["means"], params["quats"]
    scales, op = torch.exp(params["scales"]), torch.sigmoid(params["opacities"])
    sh = torch.cat([params["sh0"], params["shN"]], 1)
    img, alpha, _ = tdgs_torch.rasterization(means, quats, scales, op, sh, vm[None], K[None],
                                             W, H, sh_degree=3, rasterizer="packed",
                                             backgrounds=bg, device="cpu")
    return img[0], alpha[0, ..., 0]


@pytest.mark.parametrize("n,seed,view", [(20, 1, 1), (120, 2, 3), (300, 3, 6)])
def test_forward_matches(n, seed, view):
    st, vm, K = _scene(n, seed, view)
    img, alpha = _port(st, vm, K, bg=torch.full((1, 3), 0.3))
    sh = torch.cat([st["sh0"], st["shN"]], 1)
    rgb, a, info = R.render(st["means"], st["quats"], torch.exp(st["scales"]),
                            torch.sigmoid(st["opacities"]), sh, vm, K, W, H,
                            background=torch.full((3,), 0.3))
    assert info["live_pairs"] > 0
    assert float((img - rgb).abs().max()) < 1e-5
    assert float((alpha - a).abs().max()) < 1e-5


@pytest.mark.parametrize("n,seed,view", [(20, 4, 2), (150, 5, 5), (300, 6, 7)])
def test_gradients_match(n, seed, view):
    st, vm, K = _scene(n, seed, view)
    w = torch.randn((H, W, 3), generator=torch.Generator().manual_seed(seed))
    leaves = {k: v.clone().requires_grad_(True) for k, v in st.items()}
    img, _ = _port(leaves, vm, K)
    (img * w).sum().backward()
    _, grads, info = R.render_backward(st, vm, K, W, H, lambda rgb: (rgb * w).sum())
    for k in st:
        want = grads[k]
        got = leaves[k].grad
        scale = float(want.abs().max())
        assert scale > 0, k
        assert float((got - want).abs().max()) <= 1e-4 * scale, k


def test_bfloat16_composite_departs():
    """The control's precision moves the render well past the float32 gap."""
    st, vm, K = _scene(300, 7, 2)
    sh = torch.cat([st["sh0"], st["shN"]], 1)
    args = (st["means"], st["quats"], torch.exp(st["scales"]), torch.sigmoid(st["opacities"]),
            sh, vm, K, W, H)
    lo = R.render(*args, dtype=torch.bfloat16)[0]
    hi = R.render(*args)[0]
    img, _ = _port(st, vm, K)
    assert float((hi - img).abs().max()) < 1e-5
    assert float((hi - lo).abs().max()) > 1e-3


def test_relocation_shares_opacity():
    """Eq. 9: n copies of opacity o each get 1 − (1 − o)^(1/n)."""
    op = torch.tensor([0.5, 0.9, 0.2])
    n = torch.tensor([1, 2, 5])
    new_op, new_scale = T.relocation(op, torch.ones(3, 3), n)
    want = 1 - (1 - op) ** (1.0 / n.double())
    assert torch.allclose(new_op.double(), want, atol=1e-6)
    assert torch.allclose(new_scale[0], torch.ones(3), atol=1e-6)
    assert bool((new_scale[1:] < 1).all())
