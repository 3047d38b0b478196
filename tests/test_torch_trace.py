"""The port's tracer (``tdgs_torch/utils/profiler.py``): off, ``span`` is
one shared no-op that records nothing and opens no profiler range; on,
spans nest with their parents and step ids, ``snapshot`` sums them with
self time = inclusive − children, ``host_read`` returns the plain read and
counts its site; ``Runner.train`` on a tiny CPU scene with the MCMC
strategy records the step's layer spans with their parents, and a
``tile_sort`` host sync in every step. On the card: each span appears as a
``span:`` range of the profiler's trace that holds the interval it
recorded, and the launch attribution puts the step's kernels under their
layers."""

import statistics
import time

import pytest
import torch

from tdgs_torch.utils import profiler as P


@pytest.fixture(autouse=True)
def _tracer_off_after():
    was = P.enabled()
    P.reset_spans()
    yield
    P.enable(was)
    P.reset_spans()


def _profiled_span_names(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("span:")]


def test_off_span_is_the_shared_noop_and_records_nothing():
    P.enable(False)
    assert P.span("a") is P.span("b", step=3) is P._NOOP

    def body():
        with P.span("step", step=1):
            with P.span("render"):
                torch.ones(4).sum()
        P.count("host_sync", "x")
        assert P.host_read(torch.tensor(5), "x", int) == 5

    assert _profiled_span_names(body) == []
    assert P.records() == []
    assert P.snapshot() == {"steps": 0, "spans": {}, "counts": {}, "sync_s": {}}


def test_on_nesting_parents_steps_self_time_counts():
    P.enable(True)
    for step in (7, 8):
        with P.span("step", step=step):
            with P.span("render"):
                with P.span("project"):
                    time.sleep(0.002)
                time.sleep(0.001)
            with P.span("adam"):
                pass
            P.count("host_sync", "tile_sort")
    with P.span("outside"):
        pass
    recs = P.records()
    names = [r[0] for r in recs]
    assert names == ["step", "render", "project", "adam"] * 2 + ["outside"]
    parents = [r[3] for r in recs]
    assert parents == [-1, 0, 1, 0, -1, 4, 5, 4, -1]
    assert [r[4] for r in recs] == [7] * 4 + [8] * 4 + [None]
    assert all(r[2] >= r[1] for r in recs)

    snap = P.snapshot()
    assert snap["steps"] == 2
    assert snap["counts"] == {"host_sync": {"tile_sort": 2}}
    sp = snap["spans"]
    assert {k: v["count"] for k, v in sp.items()} == {
        "step": 2, "render": 2, "project": 2, "adam": 2, "outside": 1}
    ns = lambda i: (recs[i][2] - recs[i][1]) / 1e9  # noqa: E731
    assert sp["render"]["incl_s"] == pytest.approx(ns(1) + ns(5))
    assert sp["render"]["self_s"] == pytest.approx(ns(1) - ns(2) + ns(5) - ns(6))
    assert sp["step"]["self_s"] == pytest.approx(
        sum(ns(i) - ns(i + 1) - ns(i + 3) for i in (0, 4)))
    assert sp["project"]["self_s"] == sp["project"]["incl_s"] >= 0.004
    assert sp["render"]["self_s"] >= 0.002

    def inner():
        with P.span("inner"):
            pass

    assert _profiled_span_names(inner) == ["span:inner"]
    P.reset_spans()
    assert P.records() == [] and P.snapshot()["steps"] == 0


@pytest.mark.parametrize("on", [False, True])
def test_host_read_is_the_plain_read_and_counts_its_site(on):
    P.enable(on)
    loss, n, mask = torch.tensor(0.25), torch.tensor(12), torch.tensor([True, False, True])
    rows = torch.tensor([4, 5, 6])
    with P.span("step", step=1):
        got = (P.host_read(loss, "log", float), P.host_read(n, "tile_sort", int),
               P.host_read(loss, "log"), P.host_read(mask, "refine", rows.__getitem__))
    assert got[:3] == (0.25, 12, 0.25)
    assert type(got[1]) is int and type(got[2]) is float
    assert torch.equal(got[3], rows[mask])
    snap = P.snapshot()
    if not on:
        assert snap["counts"] == {} and P.records() == []
        return
    assert snap["counts"] == {"host_sync": {"log": 2, "tile_sort": 1, "refine": 1}}
    syncs = [r for r in P.records() if r[0] == "sync"]
    assert [r[5] for r in syncs] == ["log", "tile_sort", "log", "refine"]
    assert all(r[3] == 0 and r[4] == 1 for r in syncs)
    assert set(snap["sync_s"]) == {"log", "tile_sort", "refine"}


def test_timeit_records_through_the_span(monkeypatch):
    monkeypatch.setenv("TIMEIT", "1")
    P.enable(False)
    P.reset()
    with P.timeit("block"):
        time.sleep(0.001)
    (rec,) = P.records()
    assert rec[0] == "block"
    assert P.profiler["block"] == pytest.approx((rec[2] - rec[1]) / 1e9)
    P.reset()
    assert P.profiler == {} and P.records() == []


# -- the trainer ----------------------------------------------------------

STEP_CHILDREN = {"data", "render", "loss", "backward", "adam", "strategy"}
RENDER_CHILDREN = {"project", "sh", "tile_sort", "composite"}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path_factory.mktemp("scene"))
    make_colmap_test_scene(root, device="cpu")
    return root


def _mcmc_runner(scene, result_dir, steps, device="cpu", **kw):
    from tdgs_torch.strategy import MCMCStrategy
    from tdgs_torch.training.config import Config
    from tdgs_torch.training.trainer import Runner

    base = dict(data_dir=scene, result_dir=result_dir, data_factor=1, max_steps=steps,
                eval_steps=[], save_steps=[], ply_steps=[], sh_degree=1,
                sh_degree_interval=2, capacity=512, tile_capacity=256,
                isect_capacity=1 << 14, test_every=4, tb_every=3, opacity_reg=0.01,
                scale_reg=0.01, isect_exact=True,
                strategy=MCMCStrategy(cap_max=512, refine_start_iter=1, refine_every=4))
    cfg = Config(**dict(base, **kw))
    return Runner(cfg, device=device)


def test_runner_train_records_each_layer_span_a_step(scene, tmp_path):
    torch.set_num_threads(2)
    steps = 6
    runner = _mcmc_runner(scene, str(tmp_path / "r"), steps)
    P.enable(True)
    try:
        runner.train()
    finally:
        P.enable(False)
        runner.close()
    recs = P.records()
    by_step = {}
    for i, (name, s, e, parent, step, site) in enumerate(recs):
        assert e is not None and step is not None, recs[i]
        parent_name = recs[parent][0] if parent >= 0 else None
        by_step.setdefault(step, []).append((name, parent_name, site))
    assert sorted(by_step) == list(range(1, steps + 1))
    for step, rows in by_step.items():
        names = [n for n, _, _ in rows]
        assert names.count("step") == 1
        for name in STEP_CHILDREN | RENDER_CHILDREN:
            assert names.count(name) == 1, (step, name, names)
        parents = {n: p for n, p, _ in rows if n != "sync"}
        assert all(parents[n] == "step" for n in STEP_CHILDREN)
        assert all(parents[n] == "render" for n in RENDER_CHILDREN)
        assert parents["step"] is None
        # a log every tb_every steps and at the last; a refine every 4
        assert names.count("log") == int(step % 3 == 0 or step == steps)
        assert names.count("refine") == int(step % 4 == 0)
        if step % 4 == 0:
            assert parents["refine"] == "strategy"
        syncs = [(p, site) for n, p, site in rows if n == "sync"]
        assert ("tile_sort", "tile_sort") in syncs
    snap = P.snapshot()
    assert snap["steps"] == steps
    sites = snap["counts"]["host_sync"]
    assert sites["tile_sort"] == steps
    assert sites["log"] >= 2 * 3 and sites["mcmc_refine"] >= 1
    assert sites["refine_record"] == 2 and len(runner.refines) == 1
    sp = snap["spans"]
    for name in STEP_CHILDREN | RENDER_CHILDREN:
        assert 0 < sp[name]["self_s"] <= sp[name]["incl_s"] <= sp["step"]["incl_s"]


def test_nancheck_raises_on_a_non_finite_loss(scene, tmp_path, monkeypatch):
    monkeypatch.setenv("TDGS_NANCHECK", "1")
    runner = _mcmc_runner(scene, str(tmp_path / "n"), 2)
    runner.splats["opacities"] = torch.full_like(runner.splats["opacities"], float("nan"))
    try:
        with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
            runner.train()
    finally:
        runner.close()


# -- on the card --------------------------------------------------------------


def _card_step_trace(scene, tmp):
    """One traced step of the tiny scene on the card, the tracer on: the
    profiler's raw events and the tracer's records."""
    from torch.profiler import ProfilerActivity, profile

    # steps 1-2 build and warm the kernels; step 3, no refine and no log, is traced
    runner = _mcmc_runner(scene, str(tmp), 2, device="cuda", tb_every=100)
    runner.train()
    runner.cfg.max_steps = 3
    P.reset_spans()
    P.enable(True)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runner.train(start_step=2)
            torch.cuda.synchronize()
    finally:
        P.enable(False)
        runner.close()
    return list(prof.profiler.kineto_results.events()), P.records()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_spans_match_profiler_ranges_and_own_their_launches(cuda_device, scene,
                                                                  tmp_path):
    from portbench.layer_split import launch_spans

    events, recs = _card_step_trace(scene, tmp_path)
    ranges = {}
    for e in sorted(events, key=lambda e: e.start_ns()):
        # the host's ranges; the profiler copies each onto the device too
        if e.name().startswith("span:") and e.device_type() != torch.autograd.DeviceType.CUDA:
            ranges.setdefault(e.name()[5:], []).append(e.duration_ns())
    mine = {}
    for name, s, e, _, _, _ in recs:  # in the order they opened
        mine.setdefault(name, []).append(e - s)
    assert {k: len(v) for k, v in ranges.items()} == {k: len(v) for k, v in mine.items()}
    # each range holds its record: it opens before the recorded start and
    # closes after the recorded end, longer by the profiler's own work at
    # each end (10-150 us a range on the H100's host, more on a few)
    excess = [got - want for name in mine for got, want in zip(ranges[name], mine[name])]
    assert min(excess) >= 0 and statistics.median(excess) <= 150_000, sorted(excess)
    owner = {}
    for name, span, _, _ in launch_spans(events)["ops"]:
        owner.setdefault(name, set()).add(span)
    fwd = [k for k in owner if "rasterize_packed_fwd_kernel" in k]
    bwd = [k for k in owner if "rasterize_packed_bwd_kernel" in k]
    assert fwd and all(owner[k] == {"composite"} for k in fwd)
    assert bwd and all(owner[k] == {"backward"} for k in bwd)
    assert "adam" in set().union(*owner.values())
