"""The control of a cell: the reference in bfloat16 (the next precision
below the configuration's float32) put in the system's place at the cell's
own size, on the given seeds; or a fault: the reference with half of the
batch left out in the system's place (``--fault half``), or the system with
its relocation's draw made uniform over the live rows (``--fault draw``,
one period of the window). Each seed's compared numbers, one JSON line
each. The control and each fault have to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--fault half|draw]

The benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run  # noqa: E402


def uniform_draw(params, generator, n_before, min_opacity=0.005):
    """The system's draw of relocation sources with the law broken: every
    live row equally likely, whatever its opacity."""
    import torch

    op = torch.sigmoid(params["opacities"])
    alive = (torch.arange(op.shape[0], device=op.device) < n_before) & (op > min_opacity)
    if not bool(alive.any()):
        return None
    return torch.multinomial(alive.float(), op.shape[0], replacement=True, generator=generator)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default="", choices=("", "half", "draw"),
                    help="half: the reference with half of the batch left out in the "
                         "system's place; draw: the system with a uniform draw of "
                         "relocation sources (a training cell's planted faults)")
    args = ap.parse_args(argv)
    _, cell = run.load_cell(args.workload)
    run.settle()
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    if args.fault == "draw":
        from tdgs_torch.strategy import mcmc

        mcmc.mcmc_sample_sources = uniform_draw
    for seed in args.seeds:
        t0 = time.time()
        if args.fault == "draw":
            out = driver.run(cell, seed, 0.0, False, args.device, t0)
        else:
            kw = {"fault": args.fault} if args.fault else {}
            out = driver.run(cell, seed, 0.0, False, args.device, t0, control=True, **kw)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "correct": out["correct"],
                          "values": out["values"], "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
