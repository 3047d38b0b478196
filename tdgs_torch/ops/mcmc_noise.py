"""The MCMC position noise (port of ``inject_noise_to_position`` in
``tdgs/strategy/ops.py``): means += Σ·ε·σ(100·((1 − op) − 0.995))·scaler, so
that only near-dead gaussians (opacity ≲ 0.005) move.

:func:`inject_noise_to_position` takes the standard normal draw ``ε`` from
its caller: for CUDA tensors it is one launch of the hand-written kernel
``tdgs_torch/csrc/mcmc_noise.cu`` (one pass over the rows; the covariance
never leaves the registers), for CPU tensors the plain version,
:func:`inject_noise_to_position_plain`, the chain of tensor operations that
the kernel repeats row by row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tdgs_torch.models.gaussians import SplatParams
from tdgs_torch.ops import _build
from tdgs_torch.ops.transforms import quat_scale_to_covar_preci

KERNEL = "mcmc_noise"


def inject_noise_to_position_plain(
    params: SplatParams,
    noise: torch.Tensor,  # [C, 3] standard normal
    scaler: float,
    active_mask: Optional[torch.Tensor] = None,  # [C]
) -> SplatParams:
    """The plain PyTorch version of :func:`inject_noise_to_position`."""
    op = torch.sigmoid(params["opacities"])
    covars, _ = quat_scale_to_covar_preci(params["quats"], torch.exp(params["scales"]),
                                          compute_preci=False)
    gate = torch.sigmoid(100.0 * ((1.0 - op) - 0.995))
    step = torch.einsum("nij,nj->ni", covars, noise * gate[:, None] * scaler)
    if active_mask is not None:
        step = torch.where(active_mask[:, None], step, torch.zeros_like(step))
    return dict(params, means=params["means"] + step)


@functools.cache
def _load_kernel():
    fn = _build.load(KERNEL).tdgs_mcmc_noise
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def inject_noise_to_position(
    params: SplatParams,
    noise: torch.Tensor,  # [C, 3] standard normal
    scaler: float,
    active_mask: Optional[torch.Tensor] = None,  # [C] bool
) -> SplatParams:
    """MCMC exploration: means += Σ·ε·σ(100·((1 − op) − 0.995))·scaler, with
    Σ = R diag(exp(scales))² Rᵀ; rows outside ``active_mask`` keep their
    means. → a new dict with new ``means``; the inputs are left untouched.

    CUDA tensors launch the CUDA kernel once (or raise ``ValueError``):
    float32 means [C, 3], quats [C, 4], scales [C, 3], opacities [C] and
    noise [C, 3], each contiguous, all on one device. CPU tensors take the
    plain version."""
    means = params["means"]
    if means.device.type == "cpu":
        return inject_noise_to_position_plain(params, noise, scaler, active_mask)
    if means.device.type != "cuda":
        raise ValueError(f"unsupported device {means.device}")
    n = means.shape[0]
    ins = {"means": (means, (n, 3)), "quats": (params["quats"], (n, 4)),
           "scales": (params["scales"], (n, 3)), "opacities": (params["opacities"], (n,)),
           "noise": (noise, (n, 3))}
    for what, (t, shape) in ins.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: expected torch.float32, got {t.dtype}")
        if t.device != means.device:
            raise ValueError(f"{what}: expected device {means.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: must be contiguous")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
    if active_mask is not None:
        if active_mask.dtype != torch.bool or tuple(active_mask.shape) != (n,):
            raise ValueError(f"active_mask: expected a bool tensor of shape ({n},), got "
                             f"{active_mask.dtype} {tuple(active_mask.shape)}")
        if active_mask.device != means.device:
            raise ValueError(f"active_mask: expected device {means.device}, got "
                             f"{active_mask.device}")
        active_mask = active_mask.contiguous()
    out = torch.empty_like(means)
    fn = _load_kernel()
    with torch.cuda.device(means.device):
        stream = torch.cuda.current_stream(means.device).cuda_stream
        err = fn(*(t.data_ptr() for t, _ in ins.values()),
                 None if active_mask is None else active_mask.data_ptr(), out.data_ptr(), n,
                 scaler, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL}: CUDA launch failed with cudaError_t {err}")
    _build.count_launch(KERNEL)
    return dict(params, means=out)
