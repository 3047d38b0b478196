"""The MCMC position noise (``ops/mcmc_noise.py`` ``inject_noise_to_position``),
on the CPU and on the card.

On the CPU the wrapper takes its plain version, which must equal, bit for
bit, the chain ``MCMCStrategy`` ran before the kernel (``_chain`` below):
with and without a mask, at a row count that is not a multiple of 4, at
none, and on a sharded block's slice of the rows, its inputs left untouched
and no launch counted.

On the card (marked ``cuda``; the file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed)

    python -m pytest --noconftest -m cuda tests/test_torch_mcmc_noise.py

the kernel (``csrc/mcmc_noise.cu``) at 1M rows drawn as the benchmark's
trained state is (5% near-transparent, so that the gate opens): its means at
least as close to a float64 evaluation of the formula as the plain chain's
(worst error at most twice the chain's worst, plus an ulp of the means),
inactive rows and rows with σ(o) ≥ 0.5 (whose step is far below an ulp of
the means) bitwise equal to their inputs, one launch a call, row counts that
leave a partial block, arrays off a 16-byte boundary, and the wrapper
refusing float64, a non-contiguous input and a second device.
"""

import pytest
import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops.mcmc_noise import (
    KERNEL,
    inject_noise_to_position,
    inject_noise_to_position_plain,
)
from tdgs_torch.ops.transforms import quat_scale_to_covar_preci, quat_to_rotmat
from tests.card_scenes import NOISE_SCALER, noise_state


def _chain(params, noise, scaler, active_mask=None):
    """``inject_noise_to_position`` as it ran before the kernel."""
    op = torch.sigmoid(params["opacities"])
    covars, _ = quat_scale_to_covar_preci(params["quats"], torch.exp(params["scales"]),
                                          compute_preci=False)
    gate = torch.sigmoid(100.0 * ((1.0 - op) - 0.995))
    step = torch.einsum("nij,nj->ni", covars, noise * gate[:, None] * scaler)
    if active_mask is not None:
        step = torch.where(active_mask[:, None], step, torch.zeros_like(step))
    return dict(params, means=params["means"] + step)


def _snapshot(params, noise):
    return {k: v.clone() for k, v in params.items()}, noise.clone()


def _assert_untouched(params, noise, before):
    old_params, old_noise = before
    assert params.keys() == old_params.keys()
    for k in params:
        assert torch.equal(params[k], old_params[k]), k
    assert torch.equal(noise, old_noise)


CPU_CASES = {
    "unmasked": dict(n=257, masked=False),
    "masked": dict(n=257, masked=True),
    "aligned_rows": dict(n=512, masked=True),
    "no_rows": dict(n=0, masked=True),
    "no_rows_unmasked": dict(n=0, masked=False),
}


@pytest.mark.parametrize("case", CPU_CASES.values(), ids=CPU_CASES.keys())
def test_plain_equals_the_chain_bitwise(case):
    n, masked = case["n"], case["masked"]
    params, noise = noise_state(n, seed=n + masked)
    active = torch.arange(n) < (2 * n) // 3 if masked else None
    before = _snapshot(params, noise)
    n0 = _build.LAUNCHES.get(KERNEL, 0)
    got = inject_noise_to_position(params, noise, NOISE_SCALER, active_mask=active)
    want = _chain(params, noise, NOISE_SCALER, active)
    assert _build.LAUNCHES.get(KERNEL, 0) == n0  # the plain version launches nothing
    _assert_untouched(params, noise, before)
    assert got.keys() == params.keys()
    for k in params:
        assert got[k].shape == params[k].shape, k
        assert torch.equal(got[k], want[k]), k
        if k != "means":
            assert got[k] is params[k], k
    plain = inject_noise_to_position_plain(params, noise, NOISE_SCALER, active)
    assert torch.equal(plain["means"], got["means"])
    if masked and n:
        assert torch.equal(got["means"][~active], params["means"][~active])
        assert not torch.equal(got["means"][active], params["means"][active])


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_sharded_block_equals_the_chain_bitwise(rank):
    """The sharded trainer's call: each rank's block of the rows, the noise
    drawn for every row and sliced, the mask of the live rows sliced."""
    capacity, world = 771, 3
    params, _ = noise_state(capacity, seed=5)
    g = torch.Generator().manual_seed(6)
    n = capacity // world
    block = slice(rank * n, (rank + 1) * n)
    noise = torch.randn((capacity, 3), generator=g)[block]
    active = (torch.arange(capacity) < 600)[block]
    mine = {k: v[block] for k, v in params.items()}
    before = _snapshot(mine, noise)
    got = inject_noise_to_position(mine, noise, NOISE_SCALER, active_mask=active)
    _assert_untouched(mine, noise, before)
    assert torch.equal(got["means"], _chain(mine, noise, NOISE_SCALER, active)["means"])


def test_float64_reference_matches_the_chain_on_cpu():
    """The card tests' float64 evaluation of the formula agrees with the
    float32 chain to a few ulps of the means, and of the step, whose gate
    the chain takes from (1 − σ(o)) − 0.995 rounded to float32 (relative
    1e-5 of the step), and keeps inactive rows."""
    params, noise = noise_state(2000, seed=3)
    active = torch.arange(2000) < 1500
    want = _float64(params, noise, NOISE_SCALER, active)
    got = _chain(params, noise, NOISE_SCALER, active)["means"]
    step = (want - params["means"].double()).abs()
    room = 2 * _spacing(want.float()).double() + 1e-5 * step
    assert ((got.double() - want).abs() <= room).all()
    assert float((got.double() - want).abs().max()) > 0
    assert torch.equal(want[~active].float(), params["means"][~active])


def _float64(params, noise, scaler, active=None):
    """The means after the noise, evaluated in float64 from the same
    float32 inputs."""
    p = {k: params[k].double() for k in ("means", "quats", "scales", "opacities")}
    q = p["quats"] / torch.clamp(torch.linalg.norm(p["quats"], dim=-1, keepdim=True),
                                 min=1e-12)
    M = quat_to_rotmat(q) * torch.exp(p["scales"])[:, None, :]
    op = torch.sigmoid(p["opacities"])
    gate = torch.sigmoid(100.0 * ((1.0 - op) - 0.995))
    v = noise.double() * gate[:, None] * scaler
    step = torch.einsum("nij,nkj,nk->ni", M, M, v)
    if active is not None:
        step = torch.where(active[:, None], step, torch.zeros_like(step))
    return p["means"] + step


def _spacing(x):
    """The float32 ulp at each |x|."""
    return torch.nextafter(x.abs(), torch.full_like(x, float("inf"))) - x.abs()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _check_kernel(params, noise, active):
    """One launch; the kernel's means against float64 as close as the plain
    chain's; inactive rows bitwise their inputs; the inputs untouched."""
    before = _snapshot(params, noise)
    n0 = _build.LAUNCHES.get(KERNEL, 0)
    got = inject_noise_to_position(params, noise, NOISE_SCALER, active_mask=active)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[KERNEL] == n0 + 1
    _assert_untouched(params, noise, before)
    means = got["means"]
    assert means.shape == params["means"].shape and means.is_contiguous()
    assert all(got[k] is params[k] for k in params if k != "means")
    chain = inject_noise_to_position_plain(params, noise, NOISE_SCALER, active)["means"]
    exact = _float64(params, noise, NOISE_SCALER, active)
    chain_worst = float((chain.double() - exact).abs().max()) if exact.numel() else 0.0
    room = 2 * chain_worst + _spacing(exact.float()).double()
    assert ((means.double() - exact).abs() <= room).all()
    if active is not None:
        assert torch.equal(means[~active], params["means"][~active])
    return means


@pytest.mark.cuda
def test_kernel_matches_float64_at_1m_rows_on_card(cuda_device):
    n = 1_000_000
    params, noise = noise_state(n, seed=11, device=cuda_device)
    active = torch.arange(n, device=cuda_device) < 950_000
    means = _check_kernel(params, noise, active)
    op = torch.sigmoid(params["opacities"])
    moved = (means != params["means"]).any(-1)
    assert bool(moved[active & (op < 0.005)].all())  # the gate opens on near-dead rows
    opaque = op >= 0.5
    assert bool(opaque.any())
    assert torch.equal(means[opaque], params["means"][opaque])
    _check_kernel(params, noise, None)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5003, 256, 1])
def test_kernel_partial_blocks_and_unaligned_on_card(cuda_device, n):
    """A partial last block (the scalar path beside whole blocks), and the
    same rows one row into larger arrays: off a 16-byte boundary, the
    scalar path throughout, as a sharded block's slice can be."""
    params, noise = noise_state(n + 1, seed=n, device=cuda_device)
    active = torch.arange(n + 1, device=cuda_device) % 7 != 3
    _check_kernel(params, noise, active)
    shifted = {k: v[1:] for k, v in params.items()}
    for k in ("means", "scales"):
        assert shifted[k].data_ptr() % 16 != 0 and shifted[k].is_contiguous(), k
    _check_kernel(shifted, noise[1:], active[1:])
    _check_kernel(shifted, noise[1:], None)


@pytest.mark.cuda
def test_kernel_no_rows_on_card(cuda_device):
    params, noise = noise_state(0, device=cuda_device)
    got = inject_noise_to_position(params, noise, NOISE_SCALER,
                                   torch.zeros(0, dtype=torch.bool, device=cuda_device))
    assert got["means"].shape == (0, 3)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda_device):
    params, noise = noise_state(64, seed=14, device=cuda_device)
    active = torch.ones(64, dtype=torch.bool, device=cuda_device)
    bad = [
        (dict(params, means=params["means"].double()), noise, active, "float32"),
        (params, noise.double(), active, "float32"),
        (dict(params, quats=params["quats"].t().contiguous().t()), noise, active, "contiguous"),
        (params, torch.zeros(64, 6, device=cuda_device)[:, ::2], active, "contiguous"),
        (dict(params, scales=params["scales"].cpu()), noise, active, "device"),
        (params, noise.cpu(), active, "device"),
        (params, noise, active.cpu(), "device"),
        (params, noise[:-1], active, "shape"),
        (params, noise, active.float(), "bool"),
    ]
    for p, e, a, match in bad:
        with pytest.raises(ValueError, match=match):
            inject_noise_to_position(p, e, NOISE_SCALER, active_mask=a)
