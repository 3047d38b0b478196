"""Contrastive Gaussian Clustering losses (port of
``tdgs/segmentation/losses.py``):

- ``cgc_contrastive_clustering_loss``: per-pixel normalized features
  against the normalized mask centroids, logits scaled by each cluster's
  self-temperature φ (its mean cosine), cross-entropy over the valid
  clusters;
- ``cgc_spatial_regularizer``: on a sample of gaussians, pull each
  feature toward its nearest neighbours' and push it from the farthest;
- ``contrastive_segmentation_loss``: prototype intra-MSE + inter-cosine;
- ``cluster_quality``: intra- and inter-cluster distances, for logging.

Instance ids are small integers in [0, max_instances): a static bound with
validity masks, as in the JAX package, so no function here waits for the
device. Background pixels (id 0) render exactly zero features, so
normalizing takes ``x·rsqrt(Σx² + ε)``, whose gradient is finite at 0.
Per-instance values go to the pixels by ``index_select``, whose backward
is an ``index_add``: the backward of ``x[ids]`` sorts the ids and sums
each instance's hundreds of thousands of pixels serially (11 ms of a
23 ms segmentation step on an H100 at 480x360).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def _instance_ids(instance_mask: torch.Tensor, max_instances: int) -> torch.Tensor:
    return torch.clamp(instance_mask.reshape(-1).to(torch.int64), 0, max_instances - 1)


def _per_instance(ids: torch.Tensor, values: torch.Tensor, max_instances: int) -> torch.Tensor:
    """Sum of ``values`` rows per instance id → [max_instances, ...]."""
    out = values.new_zeros((max_instances,) + tuple(values.shape[1:]))
    return out.index_add(0, ids, values)


def cgc_contrastive_clustering_loss(
    feature_map: torch.Tensor,  # [H, W, D] rendered per-pixel features
    instance_mask: torch.Tensor,  # [H, W] int ids, 0 = background
    max_instances: int = 64,
    min_cluster_size: int = 30,
    eps: float = 1e-6,
) -> torch.Tensor:
    """CGC's contrastive clustering term; 0 unless at least two foreground
    instances have ``min_cluster_size`` pixels."""
    D = feature_map.shape[-1]
    feats = _normalize(feature_map.reshape(-1, D))  # [HW, D]
    ids = _instance_ids(instance_mask, max_instances)
    M = max_instances

    counts = _per_instance(ids, torch.ones_like(feats[:, 0]), M)
    sums = _per_instance(ids, feats, M)
    valid = (torch.arange(M, device=feats.device) != 0) & (counts >= min_cluster_size)
    n_valid = valid.sum()

    centroids = _normalize(sums / torch.clamp(counts[:, None], min=1.0))
    sims = feats @ centroids.T  # [HW, M]

    pos = sims.gather(1, ids[:, None])[:, 0]
    active = valid[ids]  # the pixel belongs to a valid foreground cluster
    zero = torch.zeros_like(pos)
    sum_pos = _per_instance(ids, torch.where(active, pos, zero), M)
    act_counts = _per_instance(ids, active.to(pos.dtype), M)
    phi = torch.clamp(sum_pos / torch.clamp(act_counts, min=1.0), min=eps)

    logits = sims / torch.clamp(phi.index_select(0, ids)[:, None], min=eps)
    logits = torch.where(valid[None, :], logits, torch.full_like(logits, -1e9))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, ids[:, None])[:, 0]
    loss = torch.where(active, nll, zero).sum() / torch.clamp(active.sum(), min=1)
    return torch.where(n_valid >= 2, loss, torch.zeros_like(loss))


def sample_indices(generator: torch.Generator, n: int, num_samples: int) -> torch.Tensor:
    """The spatial regularizer's sample: the first ``num_samples`` of a
    random permutation of ``n`` (the JAX package takes them from
    ``jax.random.permutation``; tests hand those draws in here)."""
    return torch.randperm(n, generator=generator, device=generator.device)[:num_samples]


def cgc_spatial_regularizer(
    features: torch.Tensor,  # [N, D] per-gaussian features
    positions: torch.Tensor,  # [N, 3]
    generator: torch.Generator,
    num_samples: int = 8192,
    k_near: int = 2,
    k_far: int = 5,
    lambda_near: float = 0.05,
    lambda_far: float = 0.15,
) -> torch.Tensor:
    """``λ_near·mean((1 − cos)²)`` over each sampled gaussian's ``k_near``
    nearest sampled neighbours + ``λ_far·mean(cos²)`` over its ``k_far``
    farthest. Equal distances may pick different neighbours than the JAX
    package's ``top_k`` does."""
    N = features.shape[0]
    if N < k_near + k_far + 1:
        return features.new_zeros(())
    num_samples = min(num_samples, N)
    idx = sample_indices(generator, N, num_samples).to(features.device)
    f = _normalize(features.index_select(0, idx))
    p = positions[idx].detach()

    d2 = sum((p[:, None, a] - p[None, :, a]) ** 2 for a in range(3))
    # the k_near + 1 nearest include the sample itself; the k_far farthest
    near_idx = torch.topk(-d2, k_near + 1, dim=1).indices[:, 1:]
    far_idx = torch.topk(d2, k_far, dim=1).indices

    sim = f @ f.T
    loss_near = ((1.0 - sim.gather(1, near_idx)) ** 2).mean()
    loss_far = (sim.gather(1, far_idx) ** 2).mean()
    return lambda_near * loss_near + lambda_far * loss_far


def contrastive_segmentation_loss(
    identity_map: torch.Tensor,  # [H, W, D]
    instance_mask: torch.Tensor,  # [H, W]
    max_instances: int = 64,
) -> torch.Tensor:
    """Prototype intra-MSE + inter-cosine (off-diagonal cosines pushed to
    −1); 0 unless at least two foreground instances are present."""
    D = identity_map.shape[-1]
    M = max_instances
    feats = identity_map.reshape(-1, D)
    ids = _instance_ids(instance_mask, M)

    counts = _per_instance(ids, torch.ones_like(feats[:, 0]), M)
    sums = _per_instance(ids, feats, M)
    valid = (torch.arange(M, device=feats.device) != 0) & (counts > 0)
    n_valid = valid.sum()
    protos = sums / torch.clamp(counts[:, None], min=1.0)

    diff2 = ((feats - protos.index_select(0, ids)) ** 2).sum(-1) / D
    active = valid[ids]
    per_inst = _per_instance(ids, torch.where(active, diff2, torch.zeros_like(diff2)), M)
    intra = per_inst / torch.clamp(counts, min=1.0)
    intra_loss = (torch.where(valid, intra, torch.zeros_like(intra)).sum()
                  / torch.clamp(n_valid, min=1))

    pn = _normalize(protos)
    term = (pn @ pn.T - torch.eye(M, device=feats.device) + 1.0) ** 2
    pair_valid = valid[:, None] & valid[None, :]
    inter_loss = (torch.where(pair_valid, term, torch.zeros_like(term)).sum()
                  / torch.clamp(pair_valid.sum(), min=1).to(term.dtype))
    total = intra_loss + inter_loss
    return torch.where(n_valid >= 2, total, torch.zeros_like(total))


def cluster_quality(
    identity_map: torch.Tensor,  # [H, W, D]
    instance_mask: torch.Tensor,  # [H, W]
    max_instances: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean intra-cluster distance to the centroid, mean distance between
    the centroids of the foreground instances present)."""
    D = identity_map.shape[-1]
    M = max_instances
    feats = identity_map.reshape(-1, D)
    ids = _instance_ids(instance_mask, M)
    counts = _per_instance(ids, torch.ones_like(feats[:, 0]), M)
    sums = _per_instance(ids, feats, M)
    valid = (torch.arange(M, device=feats.device) != 0) & (counts > 0)
    cents = sums / torch.clamp(counts[:, None], min=1.0)

    dist = torch.linalg.norm(feats - cents.index_select(0, ids), dim=-1)
    active = valid[ids]
    per_inst = _per_instance(ids, torch.where(active, dist, torch.zeros_like(dist)), M)
    per_inst = per_inst / torch.clamp(counts, min=1.0)
    intra = (torch.where(valid, per_inst, torch.zeros_like(per_inst)).sum()
             / torch.clamp(valid.sum(), min=1))

    pd = torch.linalg.norm(cents[:, None, :] - cents[None, :, :], dim=-1)
    iu = torch.triu(torch.ones((M, M), dtype=torch.bool, device=feats.device), diagonal=1)
    pair_valid = valid[:, None] & valid[None, :] & iu
    inter = (torch.where(pair_valid, pd, torch.zeros_like(pd)).sum()
             / torch.clamp(pair_valid.sum(), min=1))
    return intra, inter
