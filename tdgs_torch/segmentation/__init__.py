"""Identity-vector segmentation (port of ``tdgs/segmentation``): learnable
per-gaussian identity vectors rendered through the N-D feature path,
supervised against 2D instance masks by the Contrastive Gaussian
Clustering losses, then clustered into rigid-body groups."""

from tdgs_torch.segmentation.clustering import (
    anchor_centroids_from_identity_map,
    dbscan_identity_encodings,
    kmeans,
    kmeans_identity_encodings_background,
    load_cluster_groups,
    save_cluster_groups,
)
from tdgs_torch.segmentation.head import (
    SegmentationHead,
    apply_segmentation_head,
    init_segmentation_head,
)
from tdgs_torch.segmentation.losses import (
    cgc_contrastive_clustering_loss,
    cgc_spatial_regularizer,
    cluster_quality,
    contrastive_segmentation_loss,
)

__all__ = [
    "SegmentationHead",
    "init_segmentation_head",
    "apply_segmentation_head",
    "cgc_contrastive_clustering_loss",
    "cgc_spatial_regularizer",
    "contrastive_segmentation_loss",
    "cluster_quality",
    "kmeans",
    "anchor_centroids_from_identity_map",
    "kmeans_identity_encodings_background",
    "dbscan_identity_encodings",
    "save_cluster_groups",
    "load_cluster_groups",
]
