"""The work counts: the reference's live pairs on hand-built tiles, and the
formulas of ``work/counts``."""


import numpy as np
import pytest
import torch

from portbench.reference import render as R
from portbench.work import counts


def _one(mx, my, a, c, op, W=32, H=16):
    """One gaussian with conic (a, 0, c) at (mx, my): → live pairs by the
    reference, and by counting pixels by hand."""
    m2 = torch.tensor([[mx, my]])
    con = torch.tensor([[a, 0.0, c]])
    col = torch.ones((1, 3))
    opac = torch.tensor([op])
    radii = torch.tensor([[10.0, 10.0]])
    stream = R.bin_tiles(m2, radii, torch.tensor([1.0]), torch.tensor([True]), W, H)
    _, _, live = R.composite(m2, con, col, opac, stream, W, H)
    ys, xs = np.mgrid[0:H, 0:W] + 0.5
    sigma = 0.5 * (a * (xs - mx) ** 2 + c * (ys - my) ** 2)
    alpha = np.minimum(op * np.exp(-sigma), 0.999)
    return live, int((alpha >= 1 / 255).sum())


@pytest.mark.parametrize("mx,my,a,c,op", [(8.0, 8.0, 0.5, 0.5, 0.9), (15.5, 7.2, 0.1, 0.3, 0.6),
                                          (16.0, 8.0, 2.0, 2.0, 0.99)])
def test_live_pairs_one_gaussian(mx, my, a, c, op):
    live, want = _one(mx, my, a, c, op)
    assert live == want > 0


def test_live_pairs_stop_at_transmittance():
    """Ten nearly opaque gaussians stacked on one pixel: each pixel takes entries
    until the transmittance after one would fall to 1e-4."""
    n = 10
    m2 = torch.full((n, 2), 8.5)
    con = torch.tensor([[1e-6, 0.0, 1e-6]]).repeat(n, 1)
    opac = torch.full((n,), 0.95)
    depths = torch.arange(n, dtype=torch.float32)
    radii = torch.full((n, 2), 4.0)
    stream = R.bin_tiles(m2, radii, depths, torch.ones(n, dtype=torch.bool), 16, 16)
    _, alpha, live = R.composite(m2, con, torch.ones((n, 3)), opac, stream, 16, 16)
    # T after k entries is 0.05^k: three entries pass (1.25e-4 > 1e-4),
    # the fourth would leave 6.25e-6 and is not composited
    assert live == 3 * 16 * 16
    assert torch.allclose(alpha, torch.full_like(alpha, 1 - 0.05 ** 3), atol=1e-6)


def test_counts_formulas():
    fwd = counts.composite(100, 40, 10, 64)
    assert fwd["flops"] == 100 * counts.FWD_PAIR_OPS
    assert fwd["bytes"] == 4 * (40 + 10 * counts.ROW_FLOATS + 64 * 4)
    bwd = counts.composite(100, 40, 10, 64, backward=True)
    assert bwd["flops"] == 100 * counts.BWD_PAIR_OPS
    assert bwd["bytes"] == fwd["bytes"] + 4 * (64 * 3 + 10 * counts.ROW_FLOATS)
    step = counts.train_step(1000, 10, 100, 40, 64)
    assert step["bytes"] > fwd["bytes"] + bwd["bytes"] + 4 * counts.PARAM_FLOATS * 1000 * 9 - 1
    assert counts.bound_seconds(67e12, 0) == pytest.approx(1.0)
    assert counts.bound_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_breakdown_names_each_gap_by_the_shortest_range_over_it():
    from portbench import harness

    tr = {"kernels": [("k1", 0.0, 1.0), ("k2", 2.0, 3.0), ("k1", 5.0, 6.0), ("k2", 6.5, 7.0)],
          "busy_intervals": harness.merged([(0.0, 1.0), (2.0, 3.0), (5.0, 6.0), (6.5, 7.0)]),
          "host": [("outer", 0.0, 6.0), ("inner", 1.2, 1.8)]}
    out = harness.breakdown(tr)
    assert out["device_ops"] == [["k1", 2.0], ["k2", 1.5]]
    assert out["idle_gaps"] == [["outer", 2.0], ["inner", 1.0],
                                ["host, outside any call", 0.5]]
