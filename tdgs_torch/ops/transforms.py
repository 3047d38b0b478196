"""Rigid/affine transform math for 3D Gaussians (PyTorch port of
``tdgs/ops/transforms.py``).

All functions broadcast over leading batch dims. Quaternion convention:
wxyz. The covariance chain stays in components (``*_sym6``) as in the JAX
package, so projection is a sequence of elementwise ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def quat_normalize(quats: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions along the last axis."""
    norm = torch.linalg.norm(quats, dim=-1, keepdim=True)
    return quats / torch.clamp(norm, min=eps)


def quat_to_rotmat_comps(quats: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Rotation-matrix components (r00..r22, row-major) of wxyz quaternions."""
    w, x, y, z = quat_normalize(quats).unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return r00, r01, r02, r10, r11, r12, r20, r21, r22


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(Unnormalized) wxyz quaternions [..., 4] → rotation matrices [..., 3, 3]."""
    r = quat_to_rotmat_comps(quats)
    return torch.stack(r, dim=-1).reshape(quats.shape[:-1] + (3, 3))


def rotmat_to_quat(rotmat: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] → wxyz quaternions [..., 4]
    (branch-free Shepperd: the candidate with the largest pivot wins)."""
    m = rotmat
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5
    q0, q1, q2, q3 = qw.unbind(-1)
    c0 = torch.stack([q0, (m21 - m12) / (4 * q0),
                      (m02 - m20) / (4 * q0), (m10 - m01) / (4 * q0)], dim=-1)
    c1 = torch.stack([(m21 - m12) / (4 * q1), q1,
                      (m01 + m10) / (4 * q1), (m02 + m20) / (4 * q1)], dim=-1)
    c2 = torch.stack([(m02 - m20) / (4 * q2), (m01 + m10) / (4 * q2),
                      q2, (m12 + m21) / (4 * q2)], dim=-1)
    c3 = torch.stack([(m10 - m01) / (4 * q3), (m02 + m20) / (4 * q3),
                      (m12 + m21) / (4 * q3), q3], dim=-1)

    best = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # [..., 4 candidates, 4]
    index = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, index)[..., 0, :]
    return quat_normalize(q)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions (broadcasts)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by wxyz quaternions q [..., 4]:
    v' = v + 2 w (u × v) + 2 u × (u × v)."""
    q = quat_normalize(q)
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v)
    uuv = torch.linalg.cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_scale_to_covar_preci(
    quats: torch.Tensor,  # [..., 4]
    scales: torch.Tensor,  # [..., 3]
    compute_covar: bool = True,
    compute_preci: bool = True,
    triu: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Covariance Σ = R S Sᵀ Rᵀ and precision Σ⁻¹ = R S⁻¹ S⁻ᵀ Rᵀ. With
    ``triu`` the matrices come back as (xx, xy, xz, yy, yz, zz)."""
    R = quat_to_rotmat(quats)

    def _make(s):
        M = R * s[..., None, :]
        cov = M @ M.transpose(-1, -2)
        if triu:
            return torch.stack(
                [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                 cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
                dim=-1,
            )
        return cov

    covars = _make(scales) if compute_covar else None
    precis = _make(1.0 / scales) if compute_preci else None
    return covars, precis


def quat_scale_to_covar_sym6(
    quats: torch.Tensor,  # [..., 4]
    scales: torch.Tensor,  # [..., 3]
) -> Tuple[torch.Tensor, ...]:
    """Σ = R diag(s²) Rᵀ as 6 component tensors (s00, s01, s02, s11, s12, s22)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = quat_to_rotmat_comps(quats)
    v0 = scales[..., 0] * scales[..., 0]
    v1 = scales[..., 1] * scales[..., 1]
    v2 = scales[..., 2] * scales[..., 2]
    s00 = v0 * r00 * r00 + v1 * r01 * r01 + v2 * r02 * r02
    s01 = v0 * r00 * r10 + v1 * r01 * r11 + v2 * r02 * r12
    s02 = v0 * r00 * r20 + v1 * r01 * r21 + v2 * r02 * r22
    s11 = v0 * r10 * r10 + v1 * r11 * r11 + v2 * r12 * r12
    s12 = v0 * r10 * r20 + v1 * r11 * r21 + v2 * r12 * r22
    s22 = v0 * r20 * r20 + v1 * r21 * r21 + v2 * r22 * r22
    return s00, s01, s02, s11, s12, s22


def covar_cam_sym6(
    covar6: Tuple[torch.Tensor, ...],  # 6 tensors [..., N]
    viewmats: torch.Tensor,  # [..., C, 4, 4]
) -> Tuple[torch.Tensor, ...]:
    """W Σ Wᵀ per camera in component form → 6 tensors [..., C, N]."""
    s00, s01, s02, s11, s12, s22 = (c[..., None, :] for c in covar6)
    w = [[viewmats[..., i, j][..., None] for j in range(3)] for i in range(3)]
    a = [
        [
            w[i][0] * sj0 + w[i][1] * sj1 + w[i][2] * sj2
            for sj0, sj1, sj2 in (
                (s00, s01, s02), (s01, s11, s12), (s02, s12, s22)
            )
        ]
        for i in range(3)
    ]

    def dot(ai, l):
        return ai[0] * w[l][0] + ai[1] * w[l][1] + ai[2] * w[l][2]

    return (
        dot(a[0], 0), dot(a[0], 1), dot(a[0], 2),
        dot(a[1], 1), dot(a[1], 2), dot(a[2], 2),
    )


def pos_world_to_cam(
    means: torch.Tensor,  # [..., N, 3]
    viewmats: torch.Tensor,  # [..., C, 4, 4]
) -> torch.Tensor:
    """Means-only world→camera transform in components → [..., C, N, 3]."""
    x = means[..., None, :, 0]
    y = means[..., None, :, 1]
    z = means[..., None, :, 2]
    out = [
        viewmats[..., i, 0, None] * x
        + viewmats[..., i, 1, None] * y
        + viewmats[..., i, 2, None] * z
        + viewmats[..., i, 3, None]
        for i in range(3)
    ]
    return torch.stack(out, dim=-1)


def world_to_cam(
    means: torch.Tensor,  # [..., N, 3]
    covars: torch.Tensor,  # [..., N, 3, 3]
    viewmats: torch.Tensor,  # [..., C, 4, 4]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Means and covariances in each camera frame:
    means_c [..., C, N, 3], covars_c [..., C, N, 3, 3]."""
    R = viewmats[..., :3, :3]
    t = viewmats[..., :3, 3]
    means_c = torch.einsum("...cij,...nj->...cni", R, means) + t[..., :, None, :]
    covars_c = torch.einsum("...cij,...njk,...clk->...cnil", R, covars, R)
    return means_c, covars_c


def se3_apply(
    rotation: torch.Tensor,  # [..., 3, 3]
    translation: torch.Tensor,  # [..., 3]
    points: torch.Tensor,  # [..., N, 3]
) -> torch.Tensor:
    """R·p + t for point sets, broadcast over the batch dims (``tdgs/ops/
    transforms.py se3_apply``)."""
    return torch.einsum("...ij,...nj->...ni", rotation, points) + translation[..., None, :]
