"""Port parity of the sorted segment sum: the plain version of kernel 3
(``tdgs_torch.ops.segment_sum``) and the ``gather_rows_segsum`` autograd
function against the JAX package's ``sorted_segment_rows_sum`` (Pallas in
interpret mode on the CPU) and its ``gather_rows_segsum`` VJP, with the
cases of tests/test_segment_sum.py. Tolerance 1e-5 (1e-4 for the giant
segment, as that file holds the Pallas kernel): the JAX kernel sums in
float32 windows, the plain version in a float64 running sum."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops.segment_sum_pallas import ENT
from tdgs.ops.segment_sum_pallas import gather_rows_segsum as j_gather
from tdgs.ops.segment_sum_pallas import sorted_segment_rows_sum as j_segsum
from tdgs_torch.ops import _build
from tdgs_torch.ops.segment_sum import (
    gather_rows_segsum,
    segment_rows_sum,
    segment_rows_sum_plain,
    sort_ids,
)


def _cases():
    rng = np.random.default_rng(0)
    yield ("repeats_and_gaps", 16, 4 * ENT, 300,
           np.sort(rng.choice([0, 1, 2, 7, 130, 131, 257, 290, 299], size=4 * ENT)),
           1e-5)
    yield ("single_giant_segment", 8, 8 * ENT, 128, np.full(8 * ENT, 77), 1e-4)
    yield ("far_jump", 8, 2 * ENT, 2048,
           np.sort(rng.choice([3, 2000, 2047], size=2 * ENT)), 1e-5)
    # layouts that cutting the sorted positions into fixed runs makes hard
    # (the CUDA kernel's warps walk 32 positions a step): segments that
    # start exactly on every 8th and every 16th position, an id gap of
    # thousands of rows (whole windows of output rows with no position),
    # padding after the last id
    yield ("segments_on_multiples_of_8", 8, 2 * ENT, 300,
           np.repeat(np.sort(rng.choice(300, 2 * ENT // 8, replace=False)), 8), 1e-5)
    yield ("segments_on_multiples_of_16", 16, 2 * ENT, 300,
           np.repeat(np.sort(rng.choice(300, 2 * ENT // 16, replace=False)), 16), 1e-5)
    yield ("gap_of_thousands", 8, 2 * ENT, 9000,
           np.sort(rng.choice([0, 1, 5, 6500, 6501, 8999], size=2 * ENT)), 1e-5)
    # the padding's id is n_rows: past every output row here, and in a
    # column the JAX kernel computes and then cuts
    yield ("last_valid_id_then_padding", 8, 2 * ENT, 300,
           np.concatenate([np.sort(rng.integers(0, 300, 3 * ENT // 2)),
                           np.full(ENT // 2, 300)]), 1e-5)


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_sorted_segment_sum_matches_jax(case):
    _, F, E, n_rows, sids, tol = case
    sids = sids.astype(np.int32)
    rows = np.random.default_rng(E + F).normal(size=(E, F)).astype(np.float32)
    want = np.asarray(j_segsum(jnp.asarray(rows.T), jnp.asarray(sids), n_rows)).T
    # rows already grouped by id: the identity permutation
    got = segment_rows_sum(torch.from_numpy(rows), torch.arange(E), torch.from_numpy(sids),
                           n_rows)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_unsorted_ids_through_permutation_and_abs_columns():
    """Rows in stream order, read through a stable sort's permutation;
    padding slots past n_valid fall in no segment; the two |.| columns
    sum |rows[:, 0:2]|."""
    rng = np.random.default_rng(5)
    E, F, n_rows, n_valid = 700, 9, 50, 600
    ids = rng.integers(0, n_rows, size=E).astype(np.int32)
    rows = rng.normal(size=(E, F)).astype(np.float32)
    sids, perm = sort_ids(torch.from_numpy(ids), torch.tensor(n_valid))
    got = segment_rows_sum(torch.from_numpy(rows), perm, sids, n_rows, abs_cols=True)
    want = np.zeros((n_rows, F + 2), np.float64)
    for e in range(n_valid):
        want[ids[e], :F] += rows[e]
        want[ids[e], F:] += np.abs(rows[e, :2])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a stable sort: equal ids keep stream order
    p = perm.numpy()[:n_valid]
    s = sids.numpy()[:n_valid]
    assert all(p[i] < p[i + 1] for i in range(n_valid - 1) if s[i] == s[i + 1])


def test_gather_rows_segsum_vjp_matches_jax():
    rng = np.random.default_rng(3)
    n_rows, F, E = 200, 9, 3 * ENT + 17
    feats = rng.normal(size=(n_rows, F)).astype(np.float32)
    ids = rng.integers(0, n_rows, size=E, dtype=np.int32)
    v_rows = rng.normal(size=(E, F)).astype(np.float32)

    fwd_want, vjp = jax.vjp(lambda f: j_gather(f, jnp.asarray(ids)), jnp.asarray(feats))
    (g_want,) = vjp(jnp.asarray(v_rows))

    f = torch.tensor(feats, requires_grad=True)
    out = gather_rows_segsum(f, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(fwd_want))
    out.backward(torch.from_numpy(v_rows))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(g_want), rtol=1e-5, atol=1e-5)


def test_plain_version_is_deterministic_and_cpu_launches_nothing():
    rng = np.random.default_rng(9)
    rows = torch.from_numpy(rng.normal(size=(4096, 12)).astype(np.float32))
    sids, perm = sort_ids(torch.from_numpy(rng.integers(0, 64, 4096).astype(np.int32)))
    before = dict(_build.LAUNCHES)
    a = segment_rows_sum(rows, perm, sids, 64)
    b = segment_rows_sum_plain(rows, perm, sids, 64)
    assert _build.LAUNCHES == before
    assert torch.equal(a, b)
