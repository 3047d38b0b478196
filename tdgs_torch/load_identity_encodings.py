"""Cluster trained identity encodings into object groups (port of the JAX
package's ``examples/load_identity_encodings.py``, the reference's CLI of
that name).

Loads a checkpoint of a Runner trained with segmentation (a pickle:
``splats`` with ``identity_encodings``, ``segmentation_head``), renders
the head's features of the encodings to one training view (kernel 1 at
D = identity_dim on the card), and runs the anchor-initialised K-means
with the outlier-percentile background split (the reference's :387-476),
or with ``--method dbscan`` a DBSCAN eps sweep toward ``--target-clusters``
(sklearn); saves the groups as an npz (``save_cluster_groups``) and prints
a JSON summary (clusters, their sizes, the background share).

    python -m tdgs_torch.load_identity_encodings --ckpt results/x/ckpts/ckpt_30000.pkl \\
        --data-dir data/scene --out cluster_groups.npz [--device cpu]

Unlike the JAX example, only the live rows are clustered (opacity ≥ 0.05,
``rally_e2e.cluster_live_rows``); every other row is background. A
checkpoint's unused capacity rows share one encoding and would pull a
K-means anchor onto them (ROADMAP, faults on the reference side). The view
is read in the world frame the checkpoint was trained in:
``--no-normalize-world-space`` for a Runner trained without the
normalisation, such as ``tdgs_torch.rally_e2e``'s (the JAX example always
normalises).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
from typing import Any, Dict

import numpy as np
import torch


def load_and_inspect_identity_encodings(ckpt_path: str):
    """(state, encodings [N, D], head params or None) of a checkpoint.
    Only open checkpoints this program wrote: unpickling runs code."""
    with open(ckpt_path, "rb") as f:
        state = pickle.load(f)
    enc = np.asarray(state["splats"]["identity_encodings"])
    head = state.get("segmentation_head")
    print(f"identity_encodings: shape {enc.shape}, "
          f"norm mean {np.linalg.norm(enc, axis=-1).mean():.4f}", flush=True)
    return state, enc, head


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--data-factor", type=int, default=1)
    ap.add_argument("--view-index", type=int, default=0,
                    help="train view used for anchor centroids")
    ap.add_argument("--out", default="cluster_groups.npz")
    ap.add_argument("--method", choices=["kmeans", "dbscan"], default="kmeans")
    ap.add_argument("--target-clusters", type=int, default=3)
    ap.add_argument("--outlier-percentile", type=float, default=95.0)
    ap.add_argument("--plots", action="store_true",
                    help="save t-SNE scatter + PCA identity-map PNGs next to --out")
    ap.add_argument("--normalize-world-space", action=argparse.BooleanOptionalAction,
                    default=True, help="read the views normalised, as the Runner's default")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return ap


def run(args) -> Dict[str, Any]:
    """Cluster, save ``args.out`` (and the plots) → the summary."""
    from tdgs_torch._device import resolve_device
    from tdgs_torch.datasets import Dataset, Parser
    from tdgs_torch.models.gaussians import splat_activations
    from tdgs_torch.rally_e2e import cluster_live_rows
    from tdgs_torch.rendering import rasterization
    from tdgs_torch.segmentation import apply_segmentation_head, dbscan_identity_encodings
    from tdgs_torch.segmentation.clustering import save_cluster_groups
    from tdgs_torch.segmentation.head import head_from_numpy

    dev = resolve_device(args.device)
    state, enc, head = load_and_inspect_identity_encodings(args.ckpt)
    splats = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in state["splats"].items()}
    opac = torch.sigmoid(splats["opacities"]).cpu().numpy()
    head = None if head is None else head_from_numpy(head, device=dev)
    fmap = None
    with torch.no_grad():
        feats = (apply_segmentation_head(head, splats["identity_encodings"])
                 if head is not None else splats["identity_encodings"])
        if args.method == "dbscan":
            live = np.flatnonzero(opac >= 0.05)
            found = dbscan_identity_encodings(enc[live], target_clusters=args.target_clusters)
            labels = np.full(len(opac), -1, found["labels"].dtype)
            labels[live] = found["labels"]
            res = {**found, "labels": labels}
            print(f"DBSCAN: {res['n_clusters']} clusters at eps={res['eps']:.3f}", flush=True)
        else:
            # the identity map of the anchor view (the reference's
            # get_identity_map_from_checkpoint:107)
            parser = Parser(args.data_dir, factor=args.data_factor,
                            normalize=args.normalize_world_space, load_instance_masks=True)
            d = Dataset(parser, "train")[args.view_index]
            if "instance_mask" not in d:
                raise ValueError("the anchor view has no instance mask under "
                                 "masks/instance_ids_npy/")
            H, W = d["image"].shape[:2]
            means, quats, scales, opacities, _ = splat_activations(splats)
            out, _, _ = rasterization(
                means, quats, scales, opacities, feats,
                torch.as_tensor(d["viewmat"], device=dev)[None],
                torch.as_tensor(d["K"], device=dev)[None], W, H, sh_degree=None,
                rasterizer="packed_inference", device=dev)
            fmap = out[0].cpu().numpy()
            res = cluster_live_rows(fmap, d["instance_mask"], feats, opac,
                                    outlier_percentile=args.outlier_percentile, device=dev)
            print(f"K-means: {len(res['fg_ids'])} clusters; "
                  f"{(res['labels'] < 0).mean() * 100:.1f}% background", flush=True)
    save_cluster_groups(args.out, res)
    print(f"saved {args.out}", flush=True)

    if args.plots:
        from tdgs_torch.segmentation.visualize import save_identity_map, tsne_plot

        stem = os.path.splitext(args.out)[0]
        print("saved", tsne_plot(feats.cpu().numpy(), res["labels"], f"{stem}_tsne.png"))
        if fmap is not None:
            print("saved", save_identity_map(fmap, f"{stem}_identity_map.png"))
    labels = res["labels"]
    sizes = [int((labels == c).sum()) for c in np.unique(labels) if c >= 0]
    return {"method": args.method, "clusters": len(sizes), "cluster_sizes": sizes,
            "background_share": float((labels < 0).mean()), "out": args.out}


def main(argv=None) -> int:
    summary = run(build_parser().parse_args(argv))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
