"""Training command line of the port (counterpart of the JAX package's
``examples/simple_trainer.py``): the same argparse flags over the same
``Config`` fields, the same presets, plus ``--device``. It trains 3DGS, or
2DGS surfels with ``--model-type 2dgs`` (with ``--normal-loss`` and
``--dist-loss``, live from ``--normal-start-iter`` and ``--dist-start-iter``),
or 3DGUT with the ``mcmc`` preset and ``--with-ut --with-eval3d``, then
evaluates on the test views.

    python -m tdgs_torch.simple_trainer default --data-dir <colmap scene> \\
        --data-factor 1 --result-dir results/scene [--device cpu]
    python -m tdgs_torch.simple_trainer default --model-type 2dgs \\
        --normal-loss --dist-loss --data-dir <colmap scene> [--device cpu]
    python -m tdgs_torch.simple_trainer mcmc --with-ut --with-eval3d \\
        --cap-max 100000 --data-dir <colmap scene> [--device cpu]
    python -m tdgs_torch.simple_trainer default --rasterizer pallas \\
        --data-dir <colmap scene> [--device cpu]

``--rasterizer`` picks the 3DGS training render: ``packed`` (``auto``),
or the tile-dense ``pallas`` (kernels 9 and 10) or ``jax`` (its plain
tensor form); eval renders through ``packed_inference`` either way.
The ``mcmc`` preset is the MCMC strategy with ``init_opa=0.5``,
``init_scale=0.1``, ``opacity_reg=0.01`` and ``scale_reg=0.01``. Depth and
normal supervision come with ``--depth-loss`` (``--use-precomputed-depths``
for refined depth maps), ``--depth-normal-loss`` and ``--load-normals``.
With ``--pose-opt`` (and ``--pose-noise``), ``--app-opt`` and
``--use-bilateral-grid`` the trainer's optional modules train beside the
splats; ``--compression png`` compresses the trained splats and scores the
round trip. After training it renders the camera trajectory (``--render-traj-path``:
``traj_<step>.gif`` where PIL is installed, else PNG frames under
``traj_<step>/``) unless ``--disable-video`` is given. ``--no-disable-viewer``
serves the live viewer on ``--viewer-port`` while it trains, and
keeps it up after training until Ctrl+C.

With ``--sharded`` it trains gaussian-sharded, one process a rank, under
PyTorch's launcher (each rank on its card, or on the CPU with
``--device cpu``; ``--batch-size`` and the capacity divide over the ranks):

    python -m torch.distributed.run --nproc-per-node 2 -m tdgs_torch.simple_trainer \
        default --sharded --batch-size 2 --data-dir <colmap scene> [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from tdgs_torch.strategy import DefaultStrategy, MCMCStrategy
from tdgs_torch.training.config import Config
from tdgs_torch.training.trainer import Runner


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("preset", choices=["default", "mcmc"], nargs="?", default="default")
    for f in dataclasses.fields(Config):
        if f.name == "strategy":
            continue
        arg = "--" + f.name.replace("_", "-")
        if f.name == "background_color":
            # "r,g,b" or a single gray value → 3-tuple
            ap.add_argument(
                arg,
                type=lambda s: tuple((lambda v: v * 3 if len(v) == 1 else v)(
                    [float(x) for x in s.split(",")])),
                default=None, dest=f.name,
                help="constant compositing background, e.g. 0.78 or 0.2,0.5,0.9")
            continue
        if f.type == "bool" or isinstance(f.default, bool):
            ap.add_argument(arg, action=argparse.BooleanOptionalAction,
                            default=None, dest=f.name)
        elif isinstance(f.default, (int, float, str)) or f.default is None:
            if f.default is not None:
                t = type(f.default)
            else:
                ann = str(f.type)
                t = int if "int" in ann else float if "float" in ann else str
            ap.add_argument(arg, type=t, default=None, dest=f.name)
        elif (f.default_factory is not dataclasses.MISSING
              and isinstance(f.default_factory(), list)):
            ap.add_argument(arg, type=str, default=None, dest=f.name)
    ap.add_argument("--cap-max", type=int, default=1_000_000)
    ap.add_argument("--absgrad", action="store_true",
                    help="AbsGS absolute screen-gradient densification")
    ap.add_argument("--grow-grad2d", type=float, default=None,
                    help="densify threshold (0.0008 suits --absgrad)")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint to load for eval only")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return ap


def config_from_args(args) -> Config:
    if args.preset == "mcmc":
        strategy = MCMCStrategy(cap_max=args.cap_max, verbose=True)
        kwargs = dict(init_opa=0.5, init_scale=0.1, opacity_reg=0.01, scale_reg=0.01)
    else:
        strategy = DefaultStrategy(verbose=True, absgrad=args.absgrad)
        if args.grow_grad2d is not None:
            strategy.grow_grad2d = args.grow_grad2d
        elif args.absgrad:
            strategy.grow_grad2d = 0.0008
        kwargs = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is None or f.name == "strategy":
            continue
        is_list = (f.default_factory is not dataclasses.MISSING
                   and isinstance(f.default_factory(), list))
        if isinstance(v, str) and is_list:
            v = [int(x) for x in v.split(",")] if v else []
        kwargs[f.name] = v
    return Config(strategy=strategy, **kwargs)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    runner = Runner(cfg, device=args.device)

    def report(x):
        if runner.is_main:  # under --sharded every rank computes, rank 0 prints
            print(x if isinstance(x, str) else json.dumps(x), flush=True)

    try:
        if args.ckpt:
            step = runner.load_checkpoint(args.ckpt)
            report(runner.eval(step))
            return 0
        out = runner.train()
        report(out["history"][-3:])
        report(runner.eval(cfg.max_steps))
        if cfg.compression:
            # the PNG compression's round trip, scored as stage "compress"
            report(runner.run_compression(cfg.max_steps))
        if not cfg.disable_video:
            # the camera-trajectory render at the end of training
            report(runner.render_traj(cfg.max_steps, traj_path=cfg.render_traj_path))
        if runner.viewer is not None:
            # keep the live viewer up after training (examples/simple_trainer.py:128-135)
            report(f"viewer still running at http://localhost:{runner.viewer.port} "
                   "- Ctrl+C to exit")
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                pass
    finally:
        runner.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
