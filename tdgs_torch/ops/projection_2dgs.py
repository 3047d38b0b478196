"""2DGS (surfel) projection (PyTorch port of
``tdgs/ops/projection_2dgs.py:26 fully_fused_projection_2dgs``).

Builds the ray-space transform M = (K [R·quat_rot·diag(sx, sy) | t])ᵀ per
(camera, gaussian), camera-frame surfel normals turned toward the camera,
and the screen-space extent from the homogeneous centre/extent identities.
The normal is the rotation's unit third axis, t_u × t_v, as the 2DGS paper
and gsplat's CUDA projection take it; the third scale is not read. (The
JAX package scales it by that scale; see ROADMAP, faults on the reference
side.)

Three functions compute it:

- :func:`surfel_projection_chain`, the plain version: as in the JAX
  package a chain of per-component [..., C, N] tensor operations (only the
  outputs are stacked), differentiable through autograd;
- :func:`surfel_projection_vjp_plain`, the chain's closed-form VJP in the
  same component operations, from the inputs alone;
- :func:`fully_fused_projection_2dgs`, what callers take: where a gradient
  can flow to the cameras (``viewmats`` or ``Ks`` require one: pose
  optimisation) the chain; everywhere else a ``torch.autograd.Function``
  whose forward and backward are, on the card, one launch each of the
  hand-written kernels of ``tdgs_torch/csrc/surfel_project.cu`` (launch
  counters ``_build.LAUNCHES["surfel_project"]`` and
  ``["surfel_project_bwd"]``) and, on the CPU, the chain and the plain VJP.

The kernels repeat the chain's and the plain VJP's float32 operations one
by one, in the same order (their library is built without fused
multiply-adds), so on the card they equal them bit for bit. For that the
quaternion's norm is summed in a fixed order here, (w² + x²) + y² + z², in
place of ``torch.linalg.norm``, whose reduction order is the library's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from tdgs_torch.ops import _build

KERNEL = "surfel_project"
KERNEL_BWD = "surfel_project_bwd"
MAX_GRID_Y = 65535  # cameras (forward) or batch entries (backward) a launch
NORM_SQ_MIN = 1e-24  # the quaternion's squared norm is clamped here: |q| ≥ 1e-12
EXTENT_SQ_MIN = 1e-4
EXTENT_SIGMAS = 3.33


class _Geometry(NamedTuple):
    """The chain's terms of every (camera, surfel) pair, the components as
    [..., C, N] tensors (the camera's as [..., C, 1], the surfel's as
    [..., 1, N])."""

    W: list  # W[i][k], the world → camera rotation
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    q: tuple  # the unit quaternion (w, x, y, z)
    norm: torch.Tensor  # max(|q|, 1e-12)
    norm_free: torch.Tensor  # |q|² ≥ 1e-24: the norm carries a gradient
    r: tuple  # the rotation's components r00..r22, row-major
    s: list  # the two scales read
    mc: list  # the mean in the camera frame
    n_cl: list  # the surfel's third axis in the camera frame
    flip: torch.Tensor  # ±1: the normal turned toward the camera
    T: list  # T[k][j] = T_sl = K [RS_u, RS_v, mean_c]
    f: list  # test_r / d where |d| > eps, else 0
    rcp: torch.Tensor  # 1 / d (1 where d = 0)
    big: torch.Tensor  # |d| > eps


def _geometry(means, quats, scales, viewmats, Ks, eps) -> _Geometry:
    x = means[..., None, :, 0]
    y = means[..., None, :, 1]
    z = means[..., None, :, 2]
    W = [[viewmats[..., i, j, None] for j in range(3)] for i in range(3)]
    t = [viewmats[..., i, 3, None] for i in range(3)]
    mc = [W[i][0] * x + W[i][1] * y + W[i][2] * z + t[i] for i in range(3)]

    # the unit quaternion, its norm summed in a fixed order
    qw, qx, qy, qz = (quats[..., None, :, j] for j in range(4))
    sq = qw * qw + qx * qx + qy * qy + qz * qz
    norm = torch.sqrt(torch.clamp(sq, min=NORM_SQ_MIN))
    norm_free = sq >= NORM_SQ_MIN
    w, xq, yq, zq = qw / norm, qx / norm, qy / norm, qz / norm
    r = (1.0 - 2.0 * (yq * yq + zq * zq), 2.0 * (xq * yq - w * zq), 2.0 * (xq * zq + w * yq),
         2.0 * (xq * yq + w * zq), 1.0 - 2.0 * (xq * xq + zq * zq), 2.0 * (yq * zq - w * xq),
         2.0 * (xq * zq - w * yq), 2.0 * (yq * zq + w * xq), 1.0 - 2.0 * (xq * xq + yq * yq))

    # world-frame scaled surfel axes: RS_wl[k][j] = R[k][j] · s_j
    s = [scales[..., None, :, j] for j in range(2)]
    RS_wl = [[r[3 * k + j] * s[j] for j in range(2)] for k in range(3)]
    # camera-frame tangent axes: RS_cl[i][j] = Σ_k W[i][k] · RS_wl[k][j]
    RS_cl = [[W[i][0] * RS_wl[0][j] + W[i][1] * RS_wl[1][j] + W[i][2] * RS_wl[2][j]
              for j in range(2)] for i in range(3)]

    # surfel normal: the local z axis, unscaled, turned toward the camera
    n_cl = [W[i][0] * r[2] + W[i][1] * r[5] + W[i][2] * r[8] for i in range(3)]
    cos = -(n_cl[0] * mc[0] + n_cl[1] * mc[1] + n_cl[2] * mc[2])
    flip = torch.where(cos > 0, 1.0, -1.0)

    # T_sl = K [RS[:, :2] | mean_c]
    fx = Ks[..., 0, 0, None]
    fy = Ks[..., 1, 1, None]
    cx = Ks[..., 0, 2, None]
    cy = Ks[..., 1, 2, None]
    T_cl = [[RS_cl[i][0], RS_cl[i][1], mc[i]] for i in range(3)]
    T = [
        [fx * T_cl[0][j] + cx * T_cl[2][j] for j in range(3)],
        [fy * T_cl[1][j] + cy * T_cl[2][j] for j in range(3)],
        T_cl[2],
    ]

    # with h = T_sl[2] and test = (1, 1, -1): d = Σ_r h_r² test_r, f_r = test_r / d
    h = T[2]
    d = h[0] * h[0] + h[1] * h[1] - h[2] * h[2]
    d_safe = torch.where(d == 0, torch.ones_like(d), d)
    big = d.abs() > eps
    rcp = 1.0 / d_safe
    f = [torch.where(big, test_r * rcp, torch.zeros_like(d)) for test_r in (1.0, 1.0, -1.0)]
    return _Geometry(W, fx, fy, cx, cy, (w, xq, yq, zq), norm, norm_free, r, s, mc, n_cl, flip,
                     T, f, rcp, big)


def surfel_projection_chain(
    means: torch.Tensor,  # [..., N, 3]
    quats: torch.Tensor,  # [..., N, 4]
    scales: torch.Tensor,  # [..., N, 3] (z unused)
    viewmats: torch.Tensor,  # [..., C, 4, 4]
    Ks: torch.Tensor,  # [..., C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain projection, differentiable through autograd in every
    input: :func:`fully_fused_projection_2dgs`'s outputs."""
    g = _geometry(means, quats, scales, viewmats, Ks, eps)
    T, h, f = g.T, g.T[2], g.f
    normals = torch.stack([g.n_cl[i] * g.flip for i in range(3)], dim=-1)
    # M = T_slᵀ: M[i][j] = T_sl[j][i]
    M = torch.stack([torch.stack([T[j][i] for j in range(3)], dim=-1)
                     for i in range(3)], dim=-2)

    # centre and extent: means2d_k = Σ_r T_sl[k][r] h_r f_r,
    # extent²_k = means2d_k² − Σ_r T_sl[k][r]² f_r
    m2d = [T[k][0] * h[0] * f[0] + T[k][1] * h[1] * f[1] + T[k][2] * h[2] * f[2]
           for k in range(2)]
    ext = [torch.sqrt(torch.clamp(
        m2d[k] * m2d[k] - (T[k][0] * T[k][0] * f[0] + T[k][1] * T[k][1] * f[1]
                           + T[k][2] * T[k][2] * f[2]), min=EXTENT_SQ_MIN))
        for k in range(2)]
    means2d = torch.stack(m2d, dim=-1)

    depths = g.mc[2]
    radius_x = torch.ceil(EXTENT_SIGMAS * ext[0])
    radius_y = torch.ceil(EXTENT_SIGMAS * ext[1])
    valid = g.big & (depths > near_plane) & (depths < far_plane)
    valid = valid & ~((radius_x <= radius_clip) & (radius_y <= radius_clip))
    valid = valid & ((m2d[0] + radius_x > 0) & (m2d[0] - radius_x < width)
                     & (m2d[1] + radius_y > 0) & (m2d[1] - radius_y < height))
    radii = torch.where(valid[..., None], torch.stack([radius_x, radius_y], dim=-1),
                        torch.zeros_like(means2d)).detach().to(torch.int32)
    return radii, means2d, depths, M, normals


def surfel_projection_vjp_plain(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmats: torch.Tensor,
    Ks: torch.Tensor,
    v_means2d: Optional[torch.Tensor],  # [..., C, N, 2]
    v_depths: Optional[torch.Tensor],  # [..., C, N]
    v_M: Optional[torch.Tensor],  # [..., C, N, 3, 3]
    v_normals: Optional[torch.Tensor],  # [..., C, N, 3]
    eps: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain's VJP to (means, quats, scales), in closed form from the
    inputs and the cotangents (None: zero), the cameras held fixed. The
    third scale gets 0, as in the chain, which does not read it; nothing
    flows through the radii, the flip, the ``big``/``valid`` masks or the
    extent, which feeds the radii alone. The per-camera terms are summed
    over the cameras in their order. csrc/surfel_project.cu's backward
    kernel makes the same operations in the same order."""
    with torch.no_grad():
        g = _geometry(means, quats, scales, viewmats, Ks, eps)
        T, h, f, W = g.T, g.T[2], g.f, g.W
        zero = torch.zeros_like(g.rcp)
        gu, gv = (zero, zero) if v_means2d is None else v_means2d.unbind(-1)
        gz = zero if v_depths is None else v_depths
        gM = [[zero] * 3] * 3 if v_M is None else [list(row.unbind(-1))
                                                    for row in v_M.unbind(-2)]
        gn = [zero] * 3 if v_normals is None else list(v_normals.unbind(-1))

        # M = T_slᵀ, then means2d_k = Σ_r T_sl[k][r] h_r f_r
        gT = [[gM[r][k] for r in range(3)] for k in range(3)]
        a = [gu * T[0][r] + gv * T[1][r] for r in range(3)]
        for r in range(3):
            gT[0][r] = gT[0][r] + gu * h[r] * f[r]
            gT[1][r] = gT[1][r] + gv * h[r] * f[r]
        gh = [a[r] * f[r] for r in range(3)]
        gf = [a[r] * h[r] for r in range(3)]
        # f = (1, 1, -1) / d where |d| > eps; d = h0² + h1² − h2²
        g_rcp = gf[0] + gf[1] - gf[2]
        gd = torch.where(g.big, -(g_rcp * g.rcp * g.rcp), zero)
        gh[0] = gh[0] + 2.0 * h[0] * gd
        gh[1] = gh[1] + 2.0 * h[1] * gd
        gh[2] = gh[2] - 2.0 * h[2] * gd
        for r in range(3):
            gT[2][r] = gT[2][r] + gh[r]
        # T_sl = K T_cl; T_cl = [RS_cl[:, 0], RS_cl[:, 1], mean_c]; depth = mean_c[2]
        gTc = [[g.fx * gT[0][j] for j in range(3)], [g.fy * gT[1][j] for j in range(3)],
               [g.cx * gT[0][j] + g.cy * gT[1][j] + gT[2][j] for j in range(3)]]
        gTc[2][2] = gTc[2][2] + gz
        g_ncl = [gn[i] * g.flip for i in range(3)]
        # back to the world frame: Wᵀ
        g_RSwl = [[W[0][k] * gTc[0][j] + W[1][k] * gTc[1][j] + W[2][k] * gTc[2][j]
                   for j in range(2)] for k in range(3)]
        g_r2 = [W[0][k] * g_ncl[0] + W[1][k] * g_ncl[1] + W[2][k] * g_ncl[2] for k in range(3)]
        g_m = [W[0][k] * gTc[0][2] + W[1][k] * gTc[1][2] + W[2][k] * gTc[2][2] for k in range(3)]
        g_r = [g_RSwl[k][j] * g.s[j] if j < 2 else g_r2[k] for k in range(3) for j in range(3)]
        g_s = [g_RSwl[0][j] * g.r[j] + g_RSwl[1][j] * g.r[3 + j] + g_RSwl[2][j] * g.r[6 + j]
               for j in range(2)]

        # the sum over the cameras, in their order: [..., C, N] → [..., N]
        def cameras(v):
            v = v.expand(g.rcp.shape)
            if v.shape[-2] == 0:
                return v.sum(-2)
            acc = v[..., 0, :]
            for c in range(1, v.shape[-2]):
                acc = acc + v[..., c, :]
            return acc

        g_m, g_r, g_s = ([cameras(v) for v in vs] for vs in (g_m, g_r, g_s))

        # the rotation of the unit quaternion (w, x, y, z), then its norm
        w, x, y, z = (c[..., 0, :] for c in g.q)
        g00, g01, g02, g10, g11, g12, g20, g21, g22 = g_r
        gw = 2.0 * (z * (g10 - g01) + y * (g02 - g20) + x * (g21 - g12))
        gx = 2.0 * (y * (g01 + g10) + z * (g02 + g20) + w * (g21 - g12)
                    - 2.0 * x * (g11 + g22))
        gy = 2.0 * (x * (g01 + g10) + w * (g02 - g20) + z * (g12 + g21)
                    - 2.0 * y * (g00 + g22))
        gzq = 2.0 * (w * (g10 - g01) + x * (g02 + g20) + y * (g12 + g21)
                     - 2.0 * z * (g00 + g11))
        norm, free = g.norm[..., 0, :], g.norm_free[..., 0, :]
        dot = torch.where(free, w * gw + x * gx + y * gy + z * gzq, torch.zeros_like(gw))
        v_quats = torch.stack([(gq - q * dot) / norm
                               for gq, q in zip((gw, gx, gy, gzq), (w, x, y, z))], dim=-1)
        v_means = torch.stack(g_m, dim=-1)
        v_scales = torch.cat([torch.stack(g_s, dim=-1),
                              torch.zeros_like(g_s[0])[..., None].expand(
                                  g_s[0].shape + (scales.shape[-1] - 2,))], dim=-1)
    return (v_means.sum_to_size(means.shape), v_quats.sum_to_size(quats.shape),
            v_scales.sum_to_size(scales.shape))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


class _KernelArgs(ctypes.Structure):
    """``SurfelProjectArgs`` of ``csrc/surfel_project.cu``, field for field."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "means", "quats", "scales", "viewmats", "Ks", "radii", "means2d", "depths", "M",
            "normals", "v_means2d", "v_depths", "v_M", "v_normals", "v_means", "v_quats",
            "v_scales")]
        + [(name, ctypes.c_int64) for name in ("n_gauss", "n_cams", "n_batch")]
        + [(name, ctypes.c_int32) for name in ("scale_width", "vec_quats")]
        + [(name, ctypes.c_float) for name in (
            "width", "height", "near_plane", "far_plane", "radius_clip", "eps")])


@functools.cache
def _load_kernel(name):
    fn = getattr(_build.load(KERNEL), f"tdgs_{name}")
    fn.argtypes = [ctypes.POINTER(_KernelArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _checked(means, quats, scales, viewmats, Ks):
    """(batch, N, C) of kernel inputs, or ValueError: float32 on one CUDA
    device, rows [*batch, N, k] and cameras [*batch, C, ...] of the same
    batch dimensions."""
    dev = means.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if means.dim() < 2 or viewmats.dim() < 3:
        raise ValueError(f"means {tuple(means.shape)} / viewmats {tuple(viewmats.shape)}")
    batch, N, C = tuple(means.shape[:-2]), means.shape[-2], viewmats.shape[-3]
    width = scales.shape[-1] if scales.dim() else 0
    shapes = {"means": (means, (N, 3)), "quats": (quats, (N, 4)),
              "scales": (scales, (N, max(width, 2))), "viewmats": (viewmats, (C, 4, 4)),
              "Ks": (Ks, (C, 3, 3))}
    for what, (t, shape) in shapes.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: expected torch.float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: expected device {dev}, got {t.device}")
        if tuple(t.shape) != batch + shape:
            raise ValueError(f"{what}: expected shape {batch + shape}, got {tuple(t.shape)}")
    if math.prod(batch) * C > MAX_GRID_Y:
        raise ValueError(f"{math.prod(batch) * C} cameras in one launch: at most {MAX_GRID_Y}")
    return batch, N, C


def _launch(name, args, dev):
    with torch.cuda.device(dev):
        err = _load_kernel(name)(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    _build.count_launch(name)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_args(ins, batch, N, C, **kw):
    means, quats, scales, viewmats, Ks = ins
    return _KernelArgs(means=_ptr(means), quats=_ptr(quats), scales=_ptr(scales),
                       viewmats=_ptr(viewmats), Ks=_ptr(Ks), n_gauss=N, n_cams=C,
                       n_batch=math.prod(batch),
                       scale_width=scales.shape[-1], vec_quats=quats.data_ptr() % 16 == 0,
                       **{k: _ptr(v) if torch.is_tensor(v) or v is None else v
                          for k, v in kw.items()})


def surfel_project_fwd(means, quats, scales, viewmats, Ks, width, height, near_plane=0.01,
                       far_plane=1e10, radius_clip=0.0, eps=0.0):
    """One launch of the forward kernel: :func:`surfel_projection_chain`'s
    outputs, with no gradient, bit for bit. CUDA tensors only (or
    ``ValueError``): float32 on one device, of the batch dimensions of the
    cameras; they are taken contiguous."""
    batch, N, C = _checked(means, quats, scales, viewmats, Ks)
    dev = means.device
    with torch.no_grad():
        ins = tuple(t.detach().contiguous() for t in (means, quats, scales, viewmats, Ks))
        shape = batch + (C, N)
        radii = torch.empty(shape + (2,), dtype=torch.int32, device=dev)
        means2d = torch.empty(shape + (2,), dtype=torch.float32, device=dev)
        depths = torch.empty(shape, dtype=torch.float32, device=dev)
        M = torch.empty(shape + (3, 3), dtype=torch.float32, device=dev)
        normals = torch.empty(shape + (3,), dtype=torch.float32, device=dev)
    args = _kernel_args(ins, batch, N, C, radii=radii, means2d=means2d, depths=depths, M=M,
                        normals=normals, width=width, height=height, near_plane=near_plane,
                        far_plane=far_plane, radius_clip=radius_clip, eps=eps)
    _launch(KERNEL, args, dev)
    return radii, means2d, depths, M, normals


def surfel_project_bwd(means, quats, scales, viewmats, Ks, v_means2d, v_depths, v_M, v_normals,
                       eps=0.0):
    """One launch of the backward kernel: :func:`surfel_projection_vjp_plain`'s
    gradients, bit for bit. The inputs as :func:`surfel_project_fwd` takes
    them; each cotangent float32 of its output's shape, or None (zero)."""
    batch, N, C = _checked(means, quats, scales, viewmats, Ks)
    dev = means.device
    shape = batch + (C, N)
    cots = {"v_means2d": (v_means2d, (2,)), "v_depths": (v_depths, ()),
            "v_M": (v_M, (3, 3)), "v_normals": (v_normals, (3,))}
    for what, (t, tail) in cots.items():
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape + tail:
            raise ValueError(f"{what}: expected torch.float32 {shape + tail} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    with torch.no_grad():
        ins = tuple(t.detach().contiguous() for t in (means, quats, scales, viewmats, Ks))
        cot = {k: None if t is None else t.detach().contiguous() for k, (t, _) in cots.items()}
        v_means = torch.empty(ins[0].shape, dtype=torch.float32, device=dev)
        v_quats = torch.empty(ins[1].shape, dtype=torch.float32, device=dev)
        v_scales = torch.empty(ins[2].shape, dtype=torch.float32, device=dev)
    args = _kernel_args(ins, batch, N, C, **cot, v_means=v_means, v_quats=v_quats,
                        v_scales=v_scales, eps=eps)
    _launch(KERNEL_BWD, args, dev)
    return v_means, v_quats, v_scales


class _SurfelProjection(torch.autograd.Function):
    """The projection with its VJP: the kernels on the card, the chain and
    the plain VJP on the CPU. Only the inputs are saved."""

    @staticmethod
    def forward(ctx, means, quats, scales, viewmats, Ks, width, height, near_plane, far_plane,
                radius_clip, eps):
        if means.device.type == "cpu":
            out = surfel_projection_chain(means, quats, scales, viewmats, Ks, width, height,
                                          near_plane, far_plane, radius_clip, eps)
        else:
            out = surfel_project_fwd(means, quats, scales, viewmats, Ks, width, height,
                                     near_plane, far_plane, radius_clip, eps)
        ctx.save_for_backward(means, quats, scales, viewmats, Ks)
        ctx.eps = eps
        ctx.mark_non_differentiable(out[0])
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, _v_radii, v_means2d, v_depths, v_M, v_normals):
        means, quats, scales, viewmats, Ks = ctx.saved_tensors
        cots = (v_means2d, v_depths, v_M, v_normals)
        if all(v is None for v in cots) or not any(ctx.needs_input_grad[:3]):
            return (None,) * 11
        vjp = surfel_projection_vjp_plain if means.device.type == "cpu" else surfel_project_bwd
        grads = vjp(means, quats, scales, viewmats, Ks, *cots, eps=ctx.eps)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad[:3])) + (None,) * 8


def fully_fused_projection_2dgs(
    means: torch.Tensor,  # [..., N, 3]
    quats: torch.Tensor,  # [..., N, 4]
    scales: torch.Tensor,  # [..., N, 3] (z unused)
    viewmats: torch.Tensor,  # [..., C, 4, 4]
    Ks: torch.Tensor,  # [..., C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (radii [..., C, N, 2] int32, means2d [..., C, N, 2], depths
    [..., C, N], ray_transforms M [..., C, N, 3, 3], normals [..., C, N, 3]).

    Where ``viewmats`` or ``Ks`` require a gradient, the differentiable
    chain; otherwise the Function, whose gradient reaches means, quats and
    scales. CUDA tensors launch its kernels (float32, rows and cameras of
    the same batch dimensions, or ``ValueError``)."""
    if torch.is_grad_enabled() and (viewmats.requires_grad or Ks.requires_grad):
        return surfel_projection_chain(means, quats, scales, viewmats, Ks, width, height,
                                       near_plane, far_plane, radius_clip, eps)
    return _SurfelProjection.apply(means, quats, scales, viewmats, Ks, width, height,
                                   near_plane, far_plane, radius_clip, eps)
