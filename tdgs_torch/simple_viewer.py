"""Viewer command line of the port (counterpart of the JAX package's
``examples/simple_viewer.py``): load a PLY, or make the synthetic test
scene (``utils/test_data.load_test_data``), and serve it through the HTTP
viewer (``tdgs_torch.viewer``), rendered on the card by kernel 1 (3DGS), 4
(``--model-type 2dgs``) or 7 (``--model-type 3dgut``).

    python -m tdgs_torch.simple_viewer --ply scene.ply --port 8080 [--device cpu]

``--port 0`` binds a free port and prints it. With ``--distributed``,
under ``torch.distributed.run``, every rank first renders its camera of
the scene split over the ranks (``parallel.rasterization_sharded``), then
rank 0 serves:

    python -m torch.distributed.run --nproc-per-node 2 -m tdgs_torch.simple_viewer \\
        --distributed [--device cpu]

``tdgs_torch.simple_viewer_2dgs`` and ``tdgs_torch.simple_viewer_3dgut``
are this command with the family pinned.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ply", default=None)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="0.0.0.0", help="address to bind")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--scene-grid", type=int, default=1,
                    help="synthetic scene replication when no --ply")
    ap.add_argument("--distributed", action="store_true",
                    help="render through the sharded path first (torch.distributed.run)")
    ap.add_argument("--model-type", choices=["3dgs", "2dgs", "3dgut"], default="3dgs",
                    help="render family (the reference's simple_viewer.py / "
                    "simple_viewer_2dgs.py / simple_viewer_3dgut.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return ap


def load_splats(ply, scene_grid: int, device):
    """(splat dict of raw parameters on ``device``, viewer target): the PLY,
    else the synthetic scene with log scales, logit opacities and degree-3
    SH from its colours."""
    from tdgs_torch.models.gaussians import rgb_to_sh

    if ply:
        from tdgs_torch.pipeline import GaussianModel

        splats = GaussianModel(device=device).load_splats_from_ply(ply)
        return splats, splats["means"].mean(0).cpu().numpy()
    from tdgs_torch.utils.test_data import load_test_data

    means, quats, scales, opacities, colors, _, _, _, _ = load_test_data(scene_grid=scene_grid)
    n = means.shape[0]
    raw = {
        "means": means,
        "quats": quats,
        "scales": np.log(scales),
        "opacities": np.log(opacities / (1 - np.clip(opacities, 1e-4, 1 - 1e-4))),
        "sh0": rgb_to_sh(colors)[:, None, :],
        "shN": np.zeros((n, 15, 3), np.float32),
    }
    splats = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
              for k, v in raw.items()}
    return splats, means.mean(0)


def sharded_smoke_render(splats, device):
    """Every rank renders its camera (identity pose, 960x540) from the
    gaussians split over the ranks; returns (image shape, world size)."""
    from tdgs_torch.parallel import make_mesh, rasterization_sharded

    mesh = make_mesh(device=device)
    n = splats["means"].shape[0] // mesh.world
    block = slice(mesh.rank * n, (mesh.rank + 1) * n)
    sh = torch.cat([splats["sh0"], splats["shN"]], dim=-2)[block]
    vm = torch.eye(4, device=mesh.device)[None]
    K = torch.tensor([[[500.0, 0, 480], [0, 500, 270], [0, 0, 1]]], device=mesh.device)
    with torch.no_grad():
        img, _, _ = rasterization_sharded(
            splats["means"][block], splats["quats"][block], torch.exp(splats["scales"][block]),
            torch.sigmoid(splats["opacities"][block]), sh, vm, K, 960, 540, mesh, sh_degree=3)
    return tuple(img.shape), mesh.world


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from tdgs_torch._device import resolve_device
    from tdgs_torch.viewer import ViewerServer, make_splat_render_fn

    device = args.device
    rank = 0
    if args.distributed:
        from tdgs_torch.parallel.mesh import initialize_multihost, rank_device

        initialize_multihost(device)
        device = rank_device(device)
        rank = torch.distributed.get_rank()
    device = resolve_device(device)
    splats, target = load_splats(args.ply, args.scene_grid, device)
    if args.distributed:
        shape, world = sharded_smoke_render(splats, device)
        print(f"distributed smoke render OK over {world} ranks: {shape}", flush=True)
        torch.distributed.destroy_process_group()
        if rank != 0:
            return 0
    render_fn = make_splat_render_fn(splats, model_type=args.model_type, device=device)
    viewer = ViewerServer(render_fn, width=args.width, height=args.height, port=args.port,
                          target=target, host=args.host)
    try:
        viewer.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        viewer.httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
