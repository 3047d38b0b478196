"""Port parity of LPIPS and the camera trajectories against the JAX package
on the CPU, and the decode-ahead prefetcher.

- LPIPS: the random-filter proxy run on the JAX package's own filter bank
  (``convert.lpips_filters_from_numpy``), and the learned AlexNet and VGG
  paths on a synthetic npz of the right shapes that the test writes (no
  weights are downloaded); 1e-5 relative. The port's own proxy bank has
  the JAX bank's shapes and He scale and is drawn alike every time.
- ``datasets/traj.py``: the interp, ellipse and spiral paths within 1e-6.
- ``datasets/prefetch.py``: 4 request/get pairs at a time over 8 PNGs with
  4 threads for 20,000 iterations under a 60 s limit of its own (the
  reference loader's lost wakeup hung this pattern: ROADMAP queue 3), and
  a ``get`` of an index never requested decodes it.
"""

import sys
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tdgs.datasets import traj as jtraj
from tdgs.training import metrics as jmet
from tdgs_torch import convert
from tdgs_torch.datasets import traj as ttraj
from tdgs_torch.training import metrics as tmet


def _images(seed, B=2, H=64, W=56):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    return a, b


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / float(np.abs(want).max())


def test_lpips_proxy_on_the_jax_bank_matches(monkeypatch):
    monkeypatch.setenv("TDGS_LPIPS_WEIGHTS", "")
    monkeypatch.setenv("HOME", "/nonexistent")
    jmet._load_learned.cache_clear()
    try:
        a, b = _images(60)
        want = jmet.lpips(jnp.asarray(a), jnp.asarray(b))
        assert jmet.lpips_impl() == tmet.lpips_impl() == "random-proxy"
    finally:
        jmet._load_learned.cache_clear()
    bank = convert.lpips_filters_from_numpy(
        [np.asarray(w) for w in jmet._filters("float32")], device="cpu")
    got = tmet.lpips(torch.tensor(a), torch.tensor(b), filters=bank)
    assert got.shape == (2,)
    assert _rel(got.numpy(), want) <= 1e-5
    # the port's own bank: JAX's shapes and He scale, drawn alike each time
    own = tmet._proxy_filters("cpu")
    for w, (c_out, k, _), jw in zip(own, tmet._STAGES, bank):
        assert w.shape == jw.shape and w.shape[0] == c_out and w.shape[-1] == k
        he = (2.0 / (w.shape[1] * k * k)) ** 0.5
        assert abs(float(w.std()) / he - 1.0) < 0.1
    d1 = tmet.lpips(torch.tensor(a), torch.tensor(b))
    assert torch.equal(d1, tmet.lpips(torch.tensor(a), torch.tensor(b)))
    assert float(tmet.lpips(torch.tensor(a), torch.tensor(a)).max()) == 0.0
    # convolutions in true float32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def _synthetic_npz(path, net, seed):
    """Random weights of the LPIPS net's shapes (torchvision's convs, the
    lin heads)."""
    rng = np.random.default_rng(seed)
    if net == "alex":
        convs = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3), (256, 256, 3)]
        lins = [64, 192, 384, 256, 256]
    else:
        chans = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
        convs = [(c, cin, 3) for c, cin in zip(chans, [3] + chans[:-1])]
        lins = [64, 128, 256, 512, 512]
    out = {}
    for i, (c_out, c_in, k) in enumerate(convs):
        out[f"conv{i}_w"] = (rng.normal(size=(c_out, c_in, k, k))
                             * (2.0 / (c_in * k * k)) ** 0.5).astype(np.float32)
        out[f"conv{i}_b"] = (rng.normal(size=c_out) * 0.01).astype(np.float32)
    for i, c in enumerate(lins):
        out[f"lin{i}"] = rng.uniform(0, 0.1, size=c).astype(np.float32)
    np.savez(path, **out)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_learned_lpips_from_a_local_npz_matches(tmp_path, monkeypatch, net):
    path = tmp_path / f"lpips_{net}.npz"
    _synthetic_npz(path, net, seed=61)
    monkeypatch.setenv("TDGS_LPIPS_WEIGHTS", str(path))
    jmet._load_learned.cache_clear()
    try:
        a, b = _images(62, H=64, W=64)
        want = jmet.lpips(jnp.asarray(a), jnp.asarray(b), net=net)
        assert jmet.lpips_impl(net) == tmet.lpips_impl(net) == f"learned-{net}"
        j_weights = jmet._load_learned(net)
    finally:
        jmet._load_learned.cache_clear()
    got = tmet.lpips(torch.tensor(a), torch.tensor(b), net=net)
    assert _rel(got.numpy(), want) <= 1e-5
    # the weights as the port loads them are the JAX package's
    convs, lins = convert.lpips_filters_from_numpy(
        ([(np.asarray(w), np.asarray(b_)) for w, b_ in j_weights[0]],
         [np.asarray(x) for x in j_weights[1]]), device="cpu")
    t_convs, t_lins = tmet._load_learned(net)
    for (w, b_), (tw, tb) in zip(convs, t_convs):
        assert torch.equal(w, tw) and torch.equal(b_, tb)
    assert all(torch.equal(x, y) for x, y in zip(lins, t_lins))


def _poses(seed, n=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pos = np.array([4 * np.cos(0.4 * i), 4 * np.sin(0.4 * i), 1.0 + 0.1 * i])
        out.append(jtraj.viewmatrix(-pos + rng.normal(size=3) * 0.1, [0, 0, -1.0], pos))
    return np.stack(out).astype(np.float64)


@pytest.mark.parametrize("path", ["interp", "ellipse", "spiral"])
def test_trajectories_match_jax(path):
    poses = _poses(63)
    if path == "interp":
        want = jtraj.generate_interpolated_path(poses[::2], n_interp=10)
        got = ttraj.generate_interpolated_path(poses[::2], n_interp=10)
    elif path == "ellipse":
        want = jtraj.generate_ellipse_path_z(poses, n_frames=40, variation=0.2, phase=0.1)
        got = ttraj.generate_ellipse_path_z(poses, n_frames=40, variation=0.2, phase=0.1)
    else:
        want = jtraj.generate_spiral_path(poses, n_frames=40)
        got = ttraj.generate_spiral_path(poses, n_frames=40)
    assert got.shape == want.shape and got.shape[1:] == (3, 4)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    from tdgs_torch.utils.png import write_png

    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(64)
    paths, images = [], []
    for i in range(8):
        img = rng.integers(0, 256, size=(6, 8, 3), dtype=np.uint8)
        p = str(root / f"{i}.png")
        write_png(p, img)
        paths.append(p)
        images.append(img)
    return paths, images


def test_prefetch_request_get_stress_finishes(pngs, monkeypatch):
    """4 request/get pairs at a time, 8 images, 4 threads, 20,000 times;
    every get returns its own image. The loop runs in a daemon thread, so a
    lost wakeup fails the test at 60 s instead of hanging the run. The PNGs
    decode through the port's own reader, as on the card's machine (no
    PIL), which takes a sixth of PIL's time on these tiny files."""
    from tdgs_torch.datasets import prefetch
    from tdgs_torch.datasets.prefetch import Prefetcher
    from tdgs_torch.utils.png import read_png

    monkeypatch.setattr(prefetch, "imread", read_png)

    paths, images = pngs
    result = {}

    # 4 distinct indices an iteration, drawn before the clock starts
    sets = np.argsort(np.random.default_rng(65).random((20_000, 8)), axis=1)[:, :4]

    def loop(pf):
        for it, idx in enumerate(sets):
            for i in idx:
                pf.request(int(i))
            for i in idx:
                if not np.array_equal(pf.get(int(i)), images[i]):
                    result["wrong"] = (it, int(i))
                    return
        result["done"] = True

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    pf = Prefetcher(paths, n_threads=4)
    try:
        t = threading.Thread(target=loop, args=(pf,), daemon=True)
        t0 = time.monotonic()
        t.start()
        t.join(timeout=60)
        assert not t.is_alive(), f"stuck after {time.monotonic() - t0:.1f} s"
    finally:
        sys.setswitchinterval(switch)
        if not t.is_alive():
            pf.close()
    assert result == {"done": True}, result


def test_prefetch_get_of_an_unrequested_index_decodes_it(pngs):
    from tdgs_torch.datasets.prefetch import Prefetcher, box_downsample

    paths, images = pngs
    with Prefetcher(paths, n_threads=2) as pf:
        np.testing.assert_array_equal(pf.get(5), images[5])
        pf.request(3)
        pf.request(3)  # queued once
        np.testing.assert_array_equal(pf.get(3), images[3])
        np.testing.assert_array_equal(pf.get(3), images[3])  # decoded again
    with pytest.raises(RuntimeError, match="closed"):
        pf.request(1)
    with Prefetcher(paths, factor=2, n_threads=1) as pf:
        want = images[2].astype(np.int32).reshape(3, 2, 4, 2, 3).sum((1, 3)) // 4
        np.testing.assert_array_equal(pf.get(2), want.astype(np.uint8))
    assert box_downsample(images[0], 1) is images[0]
