"""Clustering identity encodings into object groups (port of
``tdgs/segmentation/clustering.py``):

- ``kmeans``: Lloyd's iterations from fixed anchors, in PyTorch on the
  device (sums by ``index_add_``), with the JAX package's expanded squared
  distance ``‖x‖² − 2x·c + ‖c‖²`` and first-index ``argmin``, so labels
  agree;
- ``anchor_centroids_from_identity_map``: one normalized anchor per
  foreground mask id, from a rendered identity map (numpy, host);
- ``kmeans_identity_encodings_background``: the main path, K-means from
  those anchors, then the distances above a percentile (numpy, host) made
  background;
- ``dbscan_identity_encodings``: an eps sweep toward a cluster count,
  scikit-learn on the host, imported where it is called;
- ``save_cluster_groups`` / ``load_cluster_groups``: the npz of gaussian
  indices per cluster.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tdgs_torch._device import DeviceLike, as_float, resolve_device


def _normalize_np(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), np.float32(eps))


def _sq_dists(X: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    return ((X ** 2).sum(1, keepdim=True) - 2.0 * X @ cents.T
            + (cents ** 2).sum(1)[None, :])


@torch.no_grad()
def kmeans(X, init_centroids, iters: int = 50,
           device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's K-means of X [N, D] from init_centroids [K, D] (one init).
    A centroid that loses every point keeps its place. Returns (labels [N]
    int64, centroids [K, D]) on ``device``."""
    dev = resolve_device(device)
    X = as_float(X, dev)
    cents = as_float(init_centroids, dev).clone()
    K = cents.shape[0]
    for _ in range(iters):
        labels = torch.argmin(_sq_dists(X, cents), dim=1)
        sums = torch.zeros_like(cents).index_add_(0, labels, X)
        counts = torch.zeros((K,), device=dev).index_add_(
            0, labels, torch.ones_like(X[:, 0]))
        cents = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts[:, None], min=1.0), cents)
    return torch.argmin(_sq_dists(X, cents), dim=1), cents


def anchor_centroids_from_identity_map(
    identity_map: np.ndarray,  # [H, W, D]
    instance_mask: np.ndarray,  # [H, W] int ids, 0 = background
) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized mean identity-map feature per foreground mask id →
    (anchors [K, D], fg_ids [K])."""
    identity_map = np.asarray(identity_map)
    instance_mask = np.asarray(instance_mask)
    ids = np.unique(instance_mask)
    ids = ids[ids != 0]
    anchors = []
    for i in ids:
        m = identity_map[instance_mask == i].mean(axis=0)
        anchors.append(m / max(np.linalg.norm(m), 1e-12))
    return np.stack(anchors), ids


def kmeans_identity_encodings_background(
    identity_map: np.ndarray,  # [H, W, D] rendered identity features
    instance_mask: np.ndarray,  # [H, W]
    encodings,  # [N, D] per-gaussian features to cluster (array or tensor)
    outlier_percentile: float = 95.0,
    iters: int = 50,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """K-means of the normalized encodings from the identity map's anchors;
    points farther from their centroid than ``outlier_percentile`` of all
    distances become background. Returns numpy 'labels' [N] (−1 =
    background), 'centroids' [K, D] and 'fg_ids' [K] (the mask id of each
    cluster)."""
    anchors, fg_ids = anchor_centroids_from_identity_map(identity_map, instance_mask)
    if isinstance(encodings, torch.Tensor):
        encodings = encodings.detach().cpu().numpy()
    feats = _normalize_np(encodings)
    labels, cents = kmeans(feats, anchors, iters=iters, device=device)
    labels = labels.cpu().numpy()
    cents = cents.cpu().numpy()

    dist = np.linalg.norm(feats - cents[labels], axis=-1)
    thresh = np.percentile(dist, outlier_percentile)
    out = labels.copy()
    out[dist > thresh] = -1
    return {"labels": out, "centroids": cents, "fg_ids": fg_ids}


def dbscan_identity_encodings(
    encodings,  # [N, D]
    target_clusters: int = 3,
    eps_values: Optional[np.ndarray] = None,
    min_samples: int = 10,
) -> Dict[str, np.ndarray]:
    """DBSCAN over the normalized encodings for each eps in turn, keeping
    the labelling whose cluster count comes closest to
    ``target_clusters`` (the first that hits it). scikit-learn, host."""
    from sklearn.cluster import DBSCAN

    if isinstance(encodings, torch.Tensor):
        encodings = encodings.detach().cpu().numpy()
    feats = _normalize_np(encodings)
    if eps_values is None:
        eps_values = np.linspace(0.05, 1.0, 20)
    best = None
    for eps in eps_values:
        labels = DBSCAN(eps=float(eps), min_samples=min_samples).fit_predict(feats)
        n = len(set(labels.tolist()) - {-1})
        if best is None or abs(n - target_clusters) < abs(best[1] - target_clusters):
            best = (labels, n, eps)
        if n == target_clusters:
            break
    labels, n, eps = best
    return {"labels": labels, "n_clusters": n, "eps": eps}


def save_cluster_groups(path: str, result: Dict[str, np.ndarray]) -> None:
    """Persist cluster groups as an npz: one integer array of gaussian
    indices per cluster key ("background" for labels < 0)."""
    groups = {}
    labels = result["labels"]
    for c in np.unique(labels):
        if c < 0:
            groups["background"] = np.where(labels < 0)[0]
        else:
            groups[str(int(c))] = np.where(labels == c)[0]
    np.savez(path, **groups)


def load_cluster_groups(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
