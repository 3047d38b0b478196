"""Fit N random gaussians to one image: the end-to-end smoke of training
(port of ``examples/image_fitting.py``). A fixed identity camera, N random
gaussians, Adam on means/scales/quats/colors/opacities against an MSE
loss; each step renders through ``rasterization``, takes the gradients by
autograd and updates with ``torch.optim.Adam`` (bias-corrected moments,
eps 1e-8 outside the square root, as ``optax.adam``).

    python -m tdgs_torch.image_fitting --height 128 --width 128 --num-points 2000

One departure from the JAX example: ``--rasterizer`` defaults to
``pallas``, the tile-dense kernels 9 and 10, where the JAX example defaults
to ``jax``, its jnp oracle, which in the port is the plain tensor form of
the same function. ``--model-type 2dgs`` raises ``NotImplementedError``: the
JAX example renders surfels through the dense 2DGS ``"jax"`` rasterizer,
which is not ported. Runs on the card unless ``--device cpu``. The last
line printed is a JSON summary with the kernel launches of the run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tdgs_torch._device import DeviceLike, resolve_device
from tdgs_torch.convert import image_fitting_params_from_numpy
from tdgs_torch.ops import _build
from tdgs_torch.rendering import rasterization


def make_target_image(height: int, width: int) -> np.ndarray:
    """Synthetic target: a red→blue gradient and green rings around the
    centre (the JAX example's)."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.zeros((height, width, 3), np.float32)
    img[..., 0] = x / width
    img[..., 2] = y / height
    r = np.sqrt((x - width / 2) ** 2 + (y - height / 2) ** 2)
    img[..., 1] = 0.5 + 0.5 * np.cos(r / 6.0)
    return np.clip(img, 0.0, 1.0)


def init_params(generator: torch.Generator, num_points: int, extent: float = 2.0,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random parameters with the JAX example's distributions, drawn on the
    CPU from ``generator`` (so a seed gives the same start on every device)
    and moved to ``device``: means uniform in [−extent, extent]² at depth 8,
    log scales of uniform [0.05, 0.25], quats near identity, raw opacities
    0.5, raw colours uniform [0, 1]."""
    dev = resolve_device(device)
    g = generator

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    params = {
        "means": uniform((num_points, 3), -extent, extent) * torch.tensor([1.0, 1.0, 0.0])
        + torch.tensor([0.0, 0.0, 8.0]),
        "scales": torch.log(uniform((num_points, 3), 0.05, 0.25)),
        "quats": torch.randn((num_points, 4), generator=g) * 0.1
        + torch.tensor([1.0, 0.0, 0.0, 0.0]),
        "opacities": torch.full((num_points,), 0.5),
        "colors": torch.rand((num_points, 3), generator=g),
    }
    return {k: v.to(dev) for k, v in params.items()}


def build_camera(height: int, width: int, device: DeviceLike = None):
    """Identity view, focal 1.2·max(H, W), principal point at the centre."""
    dev = resolve_device(device)
    f = 1.2 * max(height, width)
    viewmats = torch.eye(4, device=dev)[None]
    Ks = torch.tensor([[[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]]],
                      dtype=torch.float32, device=dev)
    return viewmats, Ks


def fit(
    height: int = 128,
    width: int = 128,
    num_points: int = 2000,
    iterations: int = 1000,
    lr: float = 1e-2,
    seed: int = 42,
    rasterizer: str = "pallas",
    log_every: int = 100,
    model_type: str = "3dgs",
    device: DeviceLike = None,
    init: Optional[Mapping[str, np.ndarray]] = None,
) -> Tuple[float, float, np.ndarray]:
    """Returns (initial_loss, final_loss, final_render [H, W, 3]). ``init``:
    starting parameters as numpy arrays (e.g. the JAX example's
    ``init_params``); otherwise ``init_params`` from ``seed``."""
    if model_type == "2dgs":
        raise NotImplementedError(
            "model_type='2dgs' renders through the dense 2DGS 'jax' rasterizer, "
            "which is not ported yet (ROADMAP queue 1, item 4)")
    if model_type != "3dgs":
        raise ValueError(f"model_type {model_type!r}")
    dev = resolve_device(device)
    target = torch.as_tensor(make_target_image(height, width), device=dev)
    if init is None:
        params = init_params(torch.Generator().manual_seed(seed), num_points, device=dev)
    else:
        params = image_fitting_params_from_numpy(init, dev)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    viewmats, Ks = build_camera(height, width, dev)
    optimizer = torch.optim.Adam(list(params.values()), lr=lr, eps=1e-8)

    def render(p):
        img, _, _ = rasterization(
            p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]),
            torch.sigmoid(p["colors"]), viewmats, Ks, width, height,
            rasterizer=rasterizer, tile_capacity=512, max_tiles_per_gauss=64, device=dev)
        return img[0]

    def loss_fn(p):
        return torch.mean((render(p) - target) ** 2)

    with torch.no_grad():
        initial_loss = float(loss_fn(params))
    t0 = time.time()
    for it in range(iterations):
        loss = loss_fn(params)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if log_every and (it % log_every == 0 or it == iterations - 1):
            print(f"iter {it:5d} loss {float(loss.detach()):.6f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    with torch.no_grad():
        final_loss = float(loss_fn(params))
        img = render(params).cpu().numpy()
    print(f"initial {initial_loss:.6f} -> final {final_loss:.6f} "
          f"({iterations} iters, {dt:.1f}s, {iterations / max(dt, 1e-9):.1f} it/s)")
    return initial_loss, final_loss, img


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--num-points", type=int, default=2000)
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--rasterizer", default="pallas",
                    choices=["jax", "pallas", "packed", "packed_inference"])
    ap.add_argument("--model-type", default="3dgs", choices=["3dgs", "2dgs"])
    ap.add_argument("--save", default=None, help="save final render PNG here")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    _build.reset_launches()
    t0 = time.time()
    initial, final, img = fit(
        args.height, args.width, args.num_points, args.iterations, lr=args.lr,
        rasterizer=args.rasterizer, model_type=args.model_type, device=args.device)
    wall = time.time() - t0
    if args.save:
        from tdgs_torch.utils.png import write_png

        write_png(args.save, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        print("saved", args.save)
    print(json.dumps({"initial_loss": initial, "final_loss": final,
                      "iterations": args.iterations, "wall_s": wall,
                      "rasterizer": args.rasterizer, "launches": dict(_build.LAUNCHES)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
