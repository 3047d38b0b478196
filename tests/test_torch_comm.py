"""Port parity of ``tdgs_torch.parallel.comm`` against ``tdgs.parallel.comm``
in ``jax.shard_map`` over the same D, on gloo worlds of 2 and 4 CPU ranks:
the four cases of ``tests/test_comm.py`` and the gradient of each
differentiable collective against ``jax.grad`` (exact: the collectives
move values and sum them, in float32 over at most 4 terms, 1e-6).

One world of each size runs every case once (``parallel.checks.comm_case``,
module-scoped); each test holds one case.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from tdgs.parallel import comm as jcomm
from tdgs.parallel import make_mesh
from tdgs_torch.parallel import checks, launch

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def port_results():
    return {D: launch.run(checks.comm_case, D, "cpu", device="cpu", timeout_s=300)
            for D in WORLDS}


def _shard(fn, D, n_in, out_specs=P("gauss")):
    mesh = make_mesh(devices=jax.devices()[:D])
    return jax.shard_map(fn, mesh=mesh, in_specs=(P("gauss"),) * n_in,
                         out_specs=out_specs, check_vma=False)


@pytest.mark.parametrize("D", WORLDS)
def test_all_gather_concats_shards(port_results, D):
    x = jnp.arange(D * 2, dtype=jnp.float32).reshape(D * 2, 1)
    want = np.asarray(_shard(lambda x: jcomm.all_gather(x)[None], D, 1)(x))
    for r, res in enumerate(port_results[D]):
        np.testing.assert_array_equal(res["gather"], want[r])


@pytest.mark.parametrize("D", WORLDS)
def test_all_to_all_transposes_blocks(port_results, D):
    x = jnp.arange(D * D, dtype=jnp.float32).reshape(D * D, 1)
    want = np.asarray(_shard(lambda x: jcomm.all_to_all(x, split_axis=0, concat_axis=0),
                             D, 1)(x)).reshape(D, D)
    got = np.stack([res["a2a"].reshape(D) for res in port_results[D]])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.arange(D * D).reshape(D, D).T)


@pytest.mark.parametrize("D", WORLDS)
def test_all_reduce_sum_and_rank(port_results, D):
    def f(x):
        s = jcomm.all_reduce_sum(x.sum())
        r = jcomm.world_rank().astype(jnp.float32)
        w = jnp.float32(jcomm.world_size())
        return jnp.stack([s, r, w])[None]

    want = np.asarray(_shard(f, D, 1)(jnp.ones((D, 1), jnp.float32)))
    got = np.stack([res["reduce_rank_world"] for res in port_results[D]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("D", WORLDS)
def test_tensor_list_variants(port_results, D):
    a = jnp.arange(D, dtype=jnp.float32).reshape(D, 1)
    b = jnp.arange(D * 2, dtype=jnp.float32).reshape(D * 2, 1)

    def f(a, b):
        ga, gb = jcomm.all_gather_tensor_list([a, b])
        return ga[None], gb[None]

    ga, gb = _shard(f, D, 2, out_specs=(P("gauss"), P("gauss")))(a, b)
    blocks = jnp.arange(D * D, dtype=jnp.float32).reshape(D * D, 1)
    # the same b on every rank, offset by its rank
    b_all = jnp.concatenate([b + 100 * r for r in range(D)])

    def g(blocks, b):
        return tuple(jcomm.all_to_all_tensor_list([blocks, b]))

    la, lb = _shard(g, D, 2, out_specs=(P("gauss"), P("gauss")))(blocks, b_all)
    la = np.asarray(la).reshape(D, D, 1)
    lb = np.asarray(lb).reshape(D, 2 * D, 1)
    for r, res in enumerate(port_results[D]):
        np.testing.assert_array_equal(res["list_a"], np.asarray(ga[r]))
        np.testing.assert_array_equal(res["list_b"], np.asarray(gb[r]))
        np.testing.assert_array_equal(res["list_a2a_blocks"], la[r])
        np.testing.assert_array_equal(res["list_a2a_b"], lb[r])


GRAD_CASES = ["gather", "reduce"] + [f"a2a_{s}{c}" for s, c in checks.A2A_AXES]


def _collective(which):
    if which == "gather":
        return jcomm.all_gather
    if which == "reduce":
        return jcomm.all_reduce_sum
    s, c = int(which[-2]), int(which[-1])
    return lambda x: jcomm.all_to_all(x, split_axis=s, concat_axis=c)


@pytest.fixture(scope="module")
def jax_grads():
    """For each D and case: jax.grad of Σ_ranks <collective(x_block),
    w_rank> w.r.t. x through shard_map, and the collective's outputs per
    rank. Every case of one D is one jitted call: each case takes its own
    copy of x, so that the gradients stay apart."""
    out = {}
    for D in WORLDS:
        inputs = checks.comm_inputs(D)
        ws = tuple(jnp.asarray(inputs[f"w_{w}"]) for w in GRAD_CASES)

        def per_rank(xs, ws):
            ys = tuple(_collective(w)(x) for w, x in zip(GRAD_CASES, xs))
            losses = jnp.stack([jnp.sum(y * wt[0]) for y, wt in zip(ys, ws)])
            return losses[None], tuple(y[None] for y in ys)

        mesh = make_mesh(devices=jax.devices()[:D])
        run = jax.shard_map(per_rank, mesh=mesh, in_specs=P("gauss"),
                            out_specs=P("gauss"), check_vma=False)

        def loss(xs):
            losses, ys = run(xs, ws)
            return losses.sum(), ys

        xs = (jnp.asarray(inputs["x"]),) * len(GRAD_CASES)
        grads, ys = jax.jit(jax.grad(loss, has_aux=True))(xs)
        out[D] = {w: (np.asarray(g), np.asarray(y)) for w, g, y in zip(GRAD_CASES, grads, ys)}
    return out


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("which", GRAD_CASES)
def test_collective_gradients_match_jax(port_results, jax_grads, D, which):
    grad, outs = jax_grads[D][which]
    got = np.concatenate([res[f"grad_{which}"] for res in port_results[D]])
    np.testing.assert_allclose(got, grad, rtol=0, atol=1e-6)
    if which.startswith("a2a"):
        for r, res in enumerate(port_results[D]):
            np.testing.assert_array_equal(res[which], outs[r])
