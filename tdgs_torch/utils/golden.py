"""Float64 reference compositing for golden checks (numpy copy of
``tdgs/utils/golden.py:27 compose_reference_f64`` and ``:97
compose_reference_2dgs_f64``, the surfels' with M's columns).

Recomposes a production render's own sorted tile stream (its meta's
means2d, conics, offsets and flatten_ids) front to back in float64: alpha
clamped to 0.999, entries under 1/255 skipped, a pixel done once its
transmittance after an entry would fall to 1e-4. It holds the compositing
kernel to the same stream, apart from projection: a re-projection at
another viewport is no reference, since the EWA projection clamps to
viewport-dependent frustum limits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

ALPHA_CLAMP = 0.999
ALPHA_THRESHOLD = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4


def compose_reference_f64(
    offsets: np.ndarray,  # [T+1] per-tile entry ranges (sorted stream)
    flatten_ids: np.ndarray,  # [capacity] entry -> gaussian id (I*N flat)
    means2d: np.ndarray,  # [I*N, 2]
    conics: np.ndarray,  # [I*N, 3]
    colors: np.ndarray,  # [I*N, D] (already SH-evaluated + clamped)
    opacities: np.ndarray,  # [I*N]
    width: int,
    height: int,
    tile_size: int,
    tile_width: int,
    tile_height: int,
    background: Optional[np.ndarray] = None,  # [D]
    image_index: int = 0,
    n_isects: Optional[int] = None,
) -> np.ndarray:
    """Render one image in f64 from a sorted intersection stream.
    ``offsets`` is either the packed [T+1] array or the [I, th, tw]
    per-tile starts from isect_offset_encode (then pass ``n_isects`` as
    the final end). Returns [height, width, D]."""
    D = colors.shape[-1]
    n_tiles = tile_width * tile_height
    offsets = np.asarray(offsets).reshape(-1)
    if offsets.shape[0] != tile_width * tile_height + 1 and n_isects is not None:
        offsets = np.concatenate([offsets, [n_isects]])
    t0 = image_index * n_tiles
    out = np.zeros((tile_height * tile_size, tile_width * tile_size, D))
    m2d = means2d.astype(np.float64)
    con = conics.astype(np.float64)
    col = colors.astype(np.float64)
    opa = opacities.astype(np.float64)

    p = np.arange(tile_size, dtype=np.float64) + 0.5
    for t in range(n_tiles):
        s, e = int(offsets[t0 + t]), int(offsets[t0 + t + 1])
        ty, tx = t // tile_width, t % tile_width
        px = (tx * tile_size + p)[None, :].repeat(tile_size, 0).reshape(-1)
        py = (ty * tile_size + p)[:, None].repeat(tile_size, 1).reshape(-1)
        if e <= s:
            tile = np.zeros((tile_size * tile_size, D))
            if background is not None:
                tile = tile + background[None, :]
            out[ty * tile_size:(ty + 1) * tile_size,
                tx * tile_size:(tx + 1) * tile_size] = tile.reshape(
                tile_size, tile_size, D)
            continue
        ids = flatten_ids[s:e]
        dx = m2d[ids, 0][:, None] - px[None, :]  # [n, P]
        dy = m2d[ids, 1][:, None] - py[None, :]
        ca = con[ids, 0][:, None]
        cb = con[ids, 1][:, None]
        cc = con[ids, 2][:, None]
        sig = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        a = np.minimum(ALPHA_CLAMP, opa[ids][:, None] * np.exp(-sig))
        a = np.where((sig < 0) | (a < ALPHA_THRESHOLD), 0.0, a)
        one = 1.0 - a
        t_after = np.cumprod(one, axis=0)  # post-entry raw transmittance
        t_before = np.vstack([np.ones((1, one.shape[1])), t_after[:-1]])
        include = t_after > TRANSMITTANCE_EPS  # CUDA break rule
        w = np.where(include, a * t_before, 0.0)
        acc = w.T @ col[ids]  # [P, D]
        t_eff = np.prod(np.where(include, one, 1.0), axis=0)
        if background is not None:
            acc = acc + t_eff[:, None] * background[None, :]
        out[ty * tile_size:(ty + 1) * tile_size,
            tx * tile_size:(tx + 1) * tile_size] = acc.reshape(
            tile_size, tile_size, D)
    return out[:height, :width]


def compose_reference_2dgs_f64(
    offsets: np.ndarray,  # [T+1] per-tile entry ranges (sorted stream)
    flatten_ids: np.ndarray,  # [capacity] entry -> gaussian id (I*N flat)
    means2d: np.ndarray,  # [I*N, 2]
    ray_transforms: np.ndarray,  # [I*N, 3, 3] (T0, T1, T2 its columns)
    channels: np.ndarray,  # [I*N, DA] accumulation channels
    opacities: np.ndarray,  # [I*N]
    width: int,
    height: int,
    tile_size: int,
    tile_width: int,
    tile_height: int,
    background: Optional[np.ndarray] = None,  # [DA] (zeros for non-color)
    image_index: int = 0,
    n_isects: Optional[int] = None,
) -> tuple:
    """The 2DGS counterpart of :func:`compose_reference_f64` over the same
    packed stream, in float64: σ = ½·min(σ3d, σ2d) with the bilinear
    cross-product expansion of the planes of M's columns T0, T1, T2 (as
    kernels 4-6 and the port's dense 2DGS rasterizer take them; the JAX
    package reads M's rows). Returns (channels_img [H, W, DA], alpha_img
    [H, W])."""
    DA = channels.shape[-1]
    n_tiles = tile_width * tile_height
    offsets = np.asarray(offsets).reshape(-1)
    if offsets.shape[0] != n_tiles + 1 and n_isects is not None:
        offsets = np.concatenate([offsets, [n_isects]])
    t0_img = image_index * n_tiles
    out = np.zeros((tile_height * tile_size, tile_width * tile_size, DA))
    alp = np.zeros((tile_height * tile_size, tile_width * tile_size))
    m2d = means2d.astype(np.float64)
    M = ray_transforms.astype(np.float64)
    ch = channels.astype(np.float64)
    opa = opacities.astype(np.float64)

    p = np.arange(tile_size, dtype=np.float64) + 0.5
    for t in range(n_tiles):
        s, e = int(offsets[t0_img + t]), int(offsets[t0_img + t + 1])
        ty, tx = t // tile_width, t % tile_width
        px = (tx * tile_size + p)[None, :].repeat(tile_size, 0).reshape(-1)
        py = (ty * tile_size + p)[:, None].repeat(tile_size, 1).reshape(-1)
        if e <= s:
            if background is not None:
                out[ty * tile_size:(ty + 1) * tile_size,
                    tx * tile_size:(tx + 1) * tile_size] += background
            continue
        ids = flatten_ids[s:e]
        # bilinear cross-product expansion: tmp = t0 + tpx·px + tpy·py
        # with t0 = T0×T1, tpx = T1×T2, tpy = T2×T0 (T_k = M[:, k])
        t0v = np.cross(M[ids, :, 0], M[ids, :, 1])  # [n, 3]
        tpx = np.cross(M[ids, :, 1], M[ids, :, 2])
        tpy = np.cross(M[ids, :, 2], M[ids, :, 0])
        tmp = (
            t0v[:, None, :]
            + tpx[:, None, :] * px[None, :, None]
            + tpy[:, None, :] * py[None, :, None]
        )  # [n, P, 3]
        bad = np.abs(tmp[..., 2]) < 1e-9
        rtz = 1.0 / np.where(bad, 1.0, tmp[..., 2])
        sigma3d = np.where(
            bad, 1e6, (tmp[..., 0] ** 2 + tmp[..., 1] ** 2) * rtz * rtz
        )
        dx = m2d[ids, 0][:, None] - px[None, :]
        dy = m2d[ids, 1][:, None] - py[None, :]
        sigma2d = 2.0 * (dx * dx + dy * dy)
        sig = 0.5 * np.minimum(sigma3d, sigma2d)
        a = np.minimum(ALPHA_CLAMP, opa[ids][:, None] * np.exp(-sig))
        a = np.where(a < ALPHA_THRESHOLD, 0.0, a)
        one = 1.0 - a
        t_after = np.cumprod(one, axis=0)
        t_before = np.vstack([np.ones((1, one.shape[1])), t_after[:-1]])
        include = t_after > TRANSMITTANCE_EPS
        w = np.where(include, a * t_before, 0.0)
        acc = w.T @ ch[ids]  # [P, DA]
        t_eff = np.prod(np.where(include, one, 1.0), axis=0)
        if background is not None:
            acc = acc + t_eff[:, None] * background[None, :]
        out[ty * tile_size:(ty + 1) * tile_size,
            tx * tile_size:(tx + 1) * tile_size] = acc.reshape(
            tile_size, tile_size, DA)
        alp[ty * tile_size:(ty + 1) * tile_size,
            tx * tile_size:(tx + 1) * tile_size] = (1.0 - t_eff).reshape(
            tile_size, tile_size)
    return out[:height, :width], alp[:height, :width]
