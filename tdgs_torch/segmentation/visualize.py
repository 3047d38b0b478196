"""Cluster and render visualizations, host-side (port of
``tdgs/segmentation/visualize.py``).

- ``tsne_plot``: a t-SNE scatter of identity encodings coloured by cluster
  label (the reference's load_identity_encodings.py:494-533), with PCA in
  its place where sklearn is missing; needs matplotlib.
- ``pca_project`` and ``identity_map_to_rgb``: a rendered identity map as
  an RGB image through PCA, numpy only.
- ``save_identity_map`` (PNG through ``utils/png.py``) and
  ``save_depth_as_image`` (a matplotlib colour map, the reference's
  examples/visualize.py).

Everything here is offline diagnostics: numpy in, PNG out; matplotlib and
sklearn are imported only by the functions that draw with them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tdgs_torch.utils.png import write_png


def tsne_plot(
    encodings: np.ndarray,  # [N, D]
    labels: np.ndarray,  # [N] int, < 0 = background
    out_path: str,
    subsample: int = 20_000,
    perplexity: float = 40.0,
    seed: int = 42,
    title: str = "t-SNE of identity encodings",
) -> str:
    """Save a 2-D t-SNE scatter of the encodings coloured by cluster label,
    the background class in grey; PCA where sklearn is missing. Returns
    ``out_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X = np.asarray(encodings, np.float32)
    y = np.asarray(labels)
    n = X.shape[0]
    if n > subsample:
        rng = np.random.default_rng(seed)
        sel = rng.choice(n, size=subsample, replace=False)
        X, y = X[sel], y[sel]

    try:
        from sklearn.manifold import TSNE
    except ImportError:
        TSNE = None
    if TSNE is not None:
        perp = min(perplexity, max(5.0, (X.shape[0] - 1) / 3.0))
        pts = TSNE(n_components=2, perplexity=perp, max_iter=300, random_state=seed,
                   init="pca").fit_transform(X)
        xl, yl = "t-SNE component 1", "t-SNE component 2"
    else:
        pts = pca_project(X, 2)
        xl, yl = "PC 1", "PC 2"

    plt.figure(figsize=(10, 8))
    bg = y < 0
    if bg.any():
        plt.scatter(pts[bg, 0], pts[bg, 1], c="lightgray", alpha=0.4, s=5,
                    label="background")
    fg = ~bg
    sc = plt.scatter(pts[fg, 0], pts[fg, 1], c=y[fg], cmap="viridis", alpha=0.6, s=5)
    handles, _ = sc.legend_elements()
    labels_txt = [f"cluster {int(c)}" for c in np.unique(y[fg])]
    if bg.any():
        import matplotlib.lines as mlines

        handles = [mlines.Line2D([], [], marker="o", color="lightgray", linestyle="",
                                 markersize=5)] + handles
        labels_txt = ["background"] + labels_txt
    plt.legend(handles=handles, labels=labels_txt, loc="best")
    plt.title(title)
    plt.xlabel(xl)
    plt.ylabel(yl)
    plt.grid(True)
    plt.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close()
    return out_path


def pca_project(X: np.ndarray, k: int = 2) -> np.ndarray:
    """The rows of ``X`` [N, D] projected on their first ``k`` principal
    components (float64 SVD of the centred rows) → float32 [N, k]."""
    X = np.asarray(X, np.float64)
    Xc = X - X.mean(axis=0)
    _, _, Vt = np.linalg.svd(Xc, full_matrices=False)
    return (Xc @ Vt[:k].T).astype(np.float32)


def identity_map_to_rgb(identity_map: np.ndarray) -> np.ndarray:
    """[H, W, D] rendered identity features → uint8 RGB [H, W, 3]: the
    three principal components scaled by their 2nd and 98th percentiles,
    so nearby features get similar colours."""
    H, W, D = identity_map.shape
    flat = np.asarray(identity_map).reshape(-1, D)
    rgb = pca_project(flat, 3)
    lo = np.percentile(rgb, 2, axis=0)
    hi = np.percentile(rgb, 98, axis=0)
    rgb = np.clip((rgb - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return (rgb.reshape(H, W, 3) * 255).astype(np.uint8)


def save_identity_map(identity_map: np.ndarray, out_path: str) -> str:
    """``identity_map_to_rgb`` written as a PNG; returns ``out_path``."""
    write_png(out_path, identity_map_to_rgb(identity_map))
    return out_path


def save_depth_as_image(
    depth_map: np.ndarray,  # [H, W]
    save_path: str,
    colormap: str = "Spectral",
    min_depth: Optional[float] = None,
    max_depth: Optional[float] = None,
    invalid_color=(0, 0, 0),
) -> str:
    """A depth map through a matplotlib colour map as a PNG, scaled to
    [min_depth, max_depth] (default the valid depths' range); pixels of
    depth ≤ 1e-6 take ``invalid_color``. Needs matplotlib."""
    d = np.asarray(depth_map, np.float32)
    if d.ndim == 3:
        d = d[..., 0] if d.shape[-1] == 1 else d[0]
    valid = d > 1e-6
    if not valid.any():
        write_png(save_path, np.zeros((*d.shape, 3), np.uint8))
        return save_path
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import colormaps

    lo = float(d[valid].min()) if min_depth is None else min_depth
    hi = float(d[valid].max()) if max_depth is None else max_depth
    hi = max(hi, lo + 1e-6)
    norm = np.zeros_like(d)
    norm[valid] = (d[valid] - lo) / (hi - lo)
    img = (colormaps.get_cmap(colormap)(norm)[..., :3] * 255).astype(np.uint8)
    img[~valid] = np.asarray(invalid_color, np.uint8)
    write_png(save_path, img)
    return save_path
