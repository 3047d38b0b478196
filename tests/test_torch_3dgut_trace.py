"""The tracer on the 3DGUT training step: a ``Runner`` step with
``with_ut`` and ``with_eval3d`` and the tracer on opens ``render`` >
``project``, ``sh``, ``tile_sort``, ``composite``, and inside
``composite`` the world-space path's ``eval3d_rays`` (the tile rays) and
``eval3d_rows`` (the feature rows and their gather into stream order);
with the tracer off it opens none. On the card, each step launches kernel
7's training call once and kernel 8 once (``_build.LAUNCHES``), and kernel
7's forward-only call not at all."""

import pytest
import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops import rasterize_eval3d_packed as E
from tdgs_torch.utils import profiler as P
from tests.test_torch_trace import RENDER_CHILDREN, _mcmc_runner

EVAL3D_CHILDREN = {"eval3d_rays", "eval3d_rows"}


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


def _runner(scene, result_dir, steps, device="cpu"):
    return _mcmc_runner(scene, result_dir, steps, device=device, with_ut=True,
                        with_eval3d=True, tb_every=100)


@pytest.mark.parametrize("on", [True, False])
def test_3dgut_step_spans(scene, tmp_path, on):
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
        for name in RENDER_CHILDREN | EVAL3D_CHILDREN:
            assert names.count(name) == 1, (step, name, names)
        parents = {n: p for n, p in rows if n != "sync"}
        assert all(parents[n] == "render" for n in RENDER_CHILDREN)
        assert all(parents[n] == "composite" for n in EVAL3D_CHILDREN)
        assert parents["render"] == "step"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels 7 and 8 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_launches_kernels_7_and_8_once_a_step(cuda_device, scene, tmp_path):
    steps = 3
    runner = _runner(scene, str(tmp_path / "c"), steps, device="cuda")
    _build.reset_launches()
    try:
        runner.train()
        torch.cuda.synchronize()
    finally:
        runner.close()
    assert _build.LAUNCHES.get(E.KERNEL_TRAIN, 0) == steps
    assert _build.LAUNCHES.get(E.KERNEL_BWD, 0) == steps
    assert _build.LAUNCHES.get(E.KERNEL_FWD, 0) == 0
