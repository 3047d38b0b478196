"""The tracer on the 2DGS training step, and the DefaultStrategy's stop.

- A 2DGS ``Runner`` step with the tracer on opens ``render`` > ``project``,
  ``sh``, ``tile_sort``, ``composite``, and inside ``composite`` the
  surfel path's ``surfel_rows`` (the feature rows and their gather into
  stream order) and ``depth_normal`` (the depth map's normals); with the
  tracer off it opens none.
- From ``refine_stop_iter`` on the port's DefaultStrategy neither resets
  opacities nor accumulates its screen-gradient state, as gsplat's
  ``step_post_backward`` returns at once there; the JAX package keeps
  resetting (ROADMAP, faults on the reference side), and the test expects
  that difference. Before the stop both reset alike.
- On the card, at the benchmark cell ``garden_2dgs.train``'s shape (3M
  surfels at 1297x840), each step launches kernel 5 once, kernel 6 once
  and the surfel projection's forward and backward kernels once each
  (``_build.LAUNCHES``), kernel 4 not at all, and drops no entry.
"""

import json
import os

import numpy as np
import pytest
import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops import projection_2dgs as SP
from tdgs_torch.ops import rasterize_2dgs_packed as S
from tdgs_torch.strategy import DefaultStrategy
from tdgs_torch.utils import profiler as P
from tests.test_torch_trace import RENDER_CHILDREN

SURFEL_CHILDREN = {"surfel_rows", "depth_normal"}


@pytest.fixture(autouse=True)
def _tracer_off_after():
    was = P.enabled()
    P.reset_spans()
    yield
    P.enable(was)
    P.reset_spans()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path_factory.mktemp("scene"))
    make_colmap_test_scene(root, device="cpu")
    return root


def _runner(scene, result_dir, steps, strategy=None, device="cpu"):
    from tdgs_torch.training.config import Config
    from tdgs_torch.training.trainer import Runner

    cfg = Config(data_dir=scene, result_dir=result_dir, data_factor=1, max_steps=steps,
                 eval_steps=[], save_steps=[], ply_steps=[], sh_degree=1,
                 sh_degree_interval=2, capacity=512, tile_capacity=256,
                 isect_capacity=1 << 14, test_every=4, tb_every=100, isect_exact=True,
                 model_type="2dgs", normal_loss=True, dist_loss=True, normal_start_iter=0,
                 dist_start_iter=0,
                 strategy=strategy or DefaultStrategy(refine_start_iter=0, refine_every=1000,
                                                      reset_every=10_000))
    return Runner(cfg, device=device)


@pytest.mark.parametrize("on", [True, False])
def test_2dgs_step_spans(scene, tmp_path, on):
    torch.set_num_threads(2)
    steps = 2
    runner = _runner(scene, str(tmp_path / "r"), steps)
    P.enable(on)
    try:
        runner.train()
    finally:
        P.enable(False)
        runner.close()
    recs = P.records()
    if not on:
        assert recs == [] and P.snapshot()["spans"] == {}
        return
    by_step = {}
    for name, _, e, parent, step, _ in recs:
        assert e is not None and step is not None
        by_step.setdefault(step, []).append((name, recs[parent][0] if parent >= 0 else None))
    assert sorted(by_step) == list(range(1, steps + 1))
    for step, rows in by_step.items():
        names = [n for n, _ in rows]
        for name in RENDER_CHILDREN | SURFEL_CHILDREN:
            assert names.count(name) == 1, (step, name, names)
        parents = {n: p for n, p in rows if n != "sync"}
        assert all(parents[n] == "render" for n in RENDER_CHILDREN)
        assert all(parents[n] == "composite" for n in SURFEL_CHILDREN)
        assert parents["render"] == "step"


def _state(seed=0, n=64):
    rng = np.random.default_rng(seed)
    params = {"means": rng.normal(size=(n, 3)), "quats": rng.normal(size=(n, 4)),
              "scales": rng.normal(size=(n, 3)) - 3.0, "opacities": rng.normal(size=n) + 1.0}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    moments = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    acc = {"grad2d": rng.uniform(size=n).astype(np.float32),
           "count": rng.integers(1, 5, size=n).astype(np.float32),
           "radii_norm": rng.uniform(size=n).astype(np.float32)}
    return params, moments, acc


@pytest.mark.parametrize("step", [12_000, 15_000, 18_000, 27_000])
def test_default_strategy_stop_leaves_the_state_alone(step):
    """A reset step before the stop resets alike in both packages; from the
    stop on the port leaves params, moments and state as they were, where
    the JAX package still resets the opacities and zeroes their moments."""
    import jax
    import jax.numpy as jnp

    from tdgs.strategy import DefaultStrategy as JDefault

    params, moments, acc = _state()
    # refine_every 7: the reset steps are no refine steps
    kw = dict(refine_start_iter=500, refine_stop_iter=15_000, reset_every=3000,
              refine_every=7)
    t_strat, j_strat = DefaultStrategy(**kw), JDefault(**kw)

    def tree(conv):
        p = {k: conv(v) for k, v in params.items()}
        opt = {"mu": {k: conv(v) for k, v in moments.items()},
               "nu": {k: conv(np.abs(v)) for k, v in moments.items()}}
        st = dict({k: conv(v) for k, v in acc.items()}, scene_scale=1.0)
        return p, opt, st

    tp, topt, tst = tree(torch.from_numpy)
    jp, jopt, jst = tree(jnp.asarray)
    info = {"width": 64, "height": 48}
    t_out = t_strat.step_post_backward(tp, topt, tst, step, info, torch.Generator())
    j_out = j_strat.step_post_backward(jp, jopt, jst, step, info, jax.random.PRNGKey(0))
    past = step >= kw["refine_stop_iter"]
    assert t_strat.acts_at(step) == (not past) and t_strat.reads_grads(step) == (not past)
    j_op = np.asarray(j_out[0]["opacities"])
    t_op = t_out[0]["opacities"].numpy()
    capped = np.log(0.01 / 0.99)
    assert np.allclose(j_op, np.minimum(params["opacities"], capped), atol=1e-6)
    if past:
        assert all(a is b for a, b in zip(t_out, (tp, topt, tst)))
        np.testing.assert_array_equal(t_op, params["opacities"])
        assert (j_op < params["opacities"]).any()
    else:
        np.testing.assert_allclose(t_op, j_op, atol=1e-6)
        np.testing.assert_array_equal(t_out[1]["mu"]["opacities"].numpy(), 0.0)


def test_runner_stops_tapping_past_the_stop(scene, tmp_path):
    """The Runner taps the screen-space gradient and accumulates the
    strategy's state only before ``refine_stop_iter``; a reset step past the
    stop leaves the opacities alone."""
    torch.set_num_threads(2)
    strat = DefaultStrategy(refine_start_iter=1000, refine_stop_iter=3, reset_every=4,
                            refine_every=1000)
    runner = _runner(scene, str(tmp_path / "s"), 4, strategy=strat)
    taps, states = {}, {}
    inner = runner.train_step

    def step(batch, step_no, *args, **kwargs):
        states[step_no] = {k: v.clone() for k, v in runner.strategy_state.items()
                           if isinstance(v, torch.Tensor)}
        loss, aux = inner(batch, step_no, *args, **kwargs)
        taps[step_no] = aux["v_means2d"] is not None
        return loss, aux

    runner.train_step = step
    resets = []
    post = runner.strategy_post_backward

    def strategy(step_no, info, lr):
        before = runner.splats["opacities"].clone()
        post(step_no, info, lr)
        resets.append(bool((runner.splats["opacities"] != before).any()))

    runner.strategy_post_backward = strategy
    try:
        runner.train()
    finally:
        runner.close()
    assert taps == {1: True, 2: True, 3: False, 4: False}
    assert float(states[2]["count"].sum()) > float(states[1]["count"].sum())
    assert all(torch.equal(states[3][k], runner.strategy_state[k]) for k in states[3])
    assert resets == [False] * 4


@pytest.mark.cuda
def test_card_launches_kernels_5_and_6_once_a_step_at_the_cell_shape():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels 5 and 6 have no CPU mode")
    from portbench.drivers import train_2dgs
    from portbench.drivers.train import _train, scene_dir
    from portbench.scenes.surfels import trained_surfels

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", "garden_2dgs.json")) as fd:
        cfg = json.load(fd)
    dev = torch.device("cuda")
    state = trained_surfels(cfg["state"]["n_gauss"], 2**31 + 7, dev, cfg["state"])
    runner, _, _ = train_2dgs._program(cfg, state, 7, scene_dir(cfg, dev), dev)
    del state
    dropped = []
    inner = runner.train_step

    def step(*args, **kwargs):
        loss, aux = inner(*args, **kwargs)
        dropped.append(int(aux["n_dropped"]))
        return loss, aux

    runner.train_step = step
    steps = 3
    _build.reset_launches()
    try:
        _train(runner, 15_200, steps)
        torch.cuda.synchronize()
    finally:
        runner.close()
    assert dropped == [0] * steps
    assert _build.LAUNCHES.get(S.KERNEL_TRAIN, 0) == steps
    assert _build.LAUNCHES.get(S.KERNEL_BWD, 0) == steps
    assert _build.LAUNCHES.get(S.KERNEL_FWD, 0) == 0
    assert _build.LAUNCHES.get(SP.KERNEL, 0) == steps
    assert _build.LAUNCHES.get(SP.KERNEL_BWD, 0) == steps
