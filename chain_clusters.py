"""How reliably the domino chain finds one cluster per domino: trains the
chain's scene (``tdgs_torch.rally_e2e`` at its defaults: 6 dominoes, 32
views of 480x360, capacity 24k, 2000 steps) several times on one card and
clusters each trained scene twice:

- ``all_rows``: as the JAX example does, the K-means over every row of the
  capacity, then the rows under opacity 0.05 dropped;
- ``live_rows``: as the port's chain does (``rally_e2e.cluster_live_rows``),
  the K-means over the rows of opacity 0.05 or more.

Each trained gaussian takes the domino of its nearest ground-truth gaussian
(``make_domino_scene_arrays``), or none when that one is on the ground.
For each clustering the script prints the clusters found, their sizes,
``dominoes_apart``: how many dominoes have a cluster of their own, the
cluster that holds most of that domino's gaussians and most of no other's,
and ``ground_in_clusters``: the ground's gaussians the clusters hold.

    python3 chain_clusters.py --seeds 42,42,1,2 --parallel 2

Prints one JSON line per run. The runs start ``--parallel`` at a time,
each its own process on the same card. Needs a CUDA card; the port does
not use this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def nearest_domino(means: np.ndarray, device) -> np.ndarray:
    """The ground-truth label (0 ground, 1..6 a domino) of each row's
    nearest ground-truth gaussian."""
    import torch

    from tdgs_torch.utils.test_data import make_domino_scene_arrays

    gt = make_domino_scene_arrays()
    ref = torch.as_tensor(gt["means"], device=device)
    x = torch.as_tensor(means, device=device)
    idx = torch.cat([torch.cdist(c, ref).argmin(dim=1) for c in x.split(4096)])
    return gt["labels"][idx.cpu().numpy()]


def describe(labels: np.ndarray, domino: np.ndarray, n_dominoes: int) -> dict:
    found = [int(k) for k in np.unique(labels) if k >= 0]
    sizes = [int((labels == k).sum()) for k in found]
    # the cluster holding most of each domino's gaussians
    major = []
    for d in range(1, n_dominoes + 1):
        lab = labels[(domino == d) & (labels >= 0)]
        major.append(int(np.bincount(lab).argmax()) if lab.size else -1)
    apart = sum(1 for m in major if m >= 0 and major.count(m) == 1)
    return {"clusters": len(found), "sizes": sizes, "dominoes_apart": apart,
            "ground_in_clusters": int(((domino == 0) & (labels >= 0)).sum())}


def run_one(seed: int, data_dir: str, out_dir: str) -> dict:
    import torch

    from tdgs_torch.rally_e2e import chain_config, cluster_live_rows, clustering_inputs
    from tdgs_torch.segmentation.clustering import kmeans_identity_encodings_background
    from tdgs_torch.training.trainer import Runner

    cfg = chain_config(data_dir, out_dir)
    cfg.seed = seed
    runner = Runner(cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    identity_map, instance_mask, feats, opac = clustering_inputs(runner)

    every = kmeans_identity_encodings_background(identity_map, instance_mask, feats,
                                                 device="cuda")["labels"]
    every[opac < 0.05] = -1
    live = cluster_live_rows(identity_map, instance_mask, feats, opac, device="cuda")["labels"]
    domino = nearest_domino(runner.splats["means"].detach().cpu().numpy(), "cuda")
    n = int(instance_mask.max())
    return {"seed": seed, "train_s": train_s, "rows": int(opac.shape[0]),
            "live": int((opac >= 0.05).sum()),
            "all_rows": describe(every, domino, n), "live_rows": describe(live, domino, n)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", default="42,42,1,2",
                    help="the training seed of each run, comma-separated")
    ap.add_argument("--parallel", type=int, default=2, help="runs at a time")
    ap.add_argument("--run", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--data-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]

    if args.run is not None:  # one run, in its own process
        import torch

        torch.set_num_threads(2)
        with tempfile.TemporaryDirectory(prefix=f"chain_clusters_{args.run}_") as out:
            print(json.dumps({"run": args.run, **run_one(seeds[args.run], args.data_dir,
                                                         out)}), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chain_clusters.py needs a CUDA card", file=sys.stderr)
        return 1
    from tdgs_torch.utils.test_data import make_domino_scene

    procs, rc = [], 0
    with tempfile.TemporaryDirectory(prefix="chain_clusters_") as root:
        data_dir = os.path.join(root, "data")
        make_domino_scene(data_dir, device="cuda")
        for i in range(len(seeds)):
            while sum(p.poll() is None for p in procs) >= args.parallel:
                time.sleep(1.0)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--seeds", args.seeds,
                 "--run", str(i), "--data-dir", data_dir]))
        for p in procs:
            rc |= p.wait()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
