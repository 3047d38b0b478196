"""Packed-stream rasterization (port of
``tdgs/ops/rasterize_pallas_packed.py``): the forward-only
``rasterize_to_pixels_packed_inference`` (:447) and the differentiable
``rasterize_to_pixels_packed`` (:223).

The per-tile compositing runs in hand-written CUDA kernels
(``tdgs_torch/csrc/rasterize_packed_fwd.cu``, and
``rasterize_packed_bwd.cu`` for the gradients) for CUDA tensors, and in the
plain PyTorch versions below for CPU tensors. Both read the sorted stream
as the TPU kernel does: tile t owns ``offsets[t]..offsets[t+1]`` of
``flatten_ids``, cut to ``max(tile_capacity // 128, 1) * 128`` entries.
Alpha clamp 0.999, 1/255 skip, and entry k is included iff the raw
transmittance after it, ∏_{j≤k}(1−α_j), is still above 1e-4.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops.projection import ALPHA_THRESHOLD
from tdgs_torch.ops.segment_sum import segment_rows_sum, sort_ids

ALPHA_CLAMP = 0.999
TRANSMITTANCE_EPS = 1e-4
CHUNK = 128
KERNEL = "rasterize_packed_fwd"
KERNEL_BWD = "rasterize_packed_bwd"
MAX_CHANNELS = 32


def max_entries_per_tile(tile_capacity: int) -> int:
    """Entries a tile keeps: the TPU kernel's whole-chunk rule."""
    return max(tile_capacity // CHUNK, 1) * CHUNK


def _dims(means2d, colors, image_width, image_height, tile_size):
    image_dims = tuple(means2d.shape[:-2])
    I = math.prod(image_dims) if image_dims else 1
    tile_width = math.ceil(image_width / tile_size)
    tile_height = math.ceil(image_height / tile_size)
    return image_dims, I, means2d.shape[-2], colors.shape[-1], tile_width, tile_height


class _Chunk(NamedTuple):
    """One chunk of tiles of the plain walk: n tiles, P pixels, L lanes."""

    tt: torch.Tensor  # [n] tile indices
    cnt: torch.Tensor  # [n] entries each tile keeps after the cut
    valid: torch.Tensor  # [n, L] lane < cnt
    idx: torch.Tensor  # [n, L] stream positions (0 where not valid)
    ids: torch.Tensor  # [n, L] gaussian rows (0 where not valid)
    px: torch.Tensor  # [n, P] pixel centres
    py: torch.Tensor
    geom: tuple  # what the response returned beside σ and the opacities
    vis: torch.Tensor  # [n, P, L] exp(−σ)
    op_vis: torch.Tensor  # opacity · vis, before the clamp
    alpha: torch.Tensor  # clamped, 0 where skipped
    skip: torch.Tensor  # σ < 0, α < 1/255 or not valid
    included: torch.Tensor  # raw transmittance after the entry > 1e-4
    T_prev: torch.Tensor  # raw transmittance before the entry


def _plain_walk(n_images, image_width, image_height, tile_size, offsets,
                flatten_ids, tile_capacity, budget, response, ranges=None):
    """The walk every plain version shares: each tile's cut range, α from
    the caller's σ, the skip tests and the running product with the 1e-4
    inclusion rule, in chunks of tiles whose [tiles, pixels, entries] block
    stays under ``budget`` elements. ``response(tt, idx, ids, px, py)``
    gives (σ [n, P, L], opacities [n, 1, L], geom) for tiles ``tt`` [n],
    stream positions ``idx``, gaussian rows ``ids`` [n, L] (``idx`` itself
    when ``flatten_ids`` is None: features already in stream order) and
    pixel centres ``px``, ``py`` [n, P]; σ < 0 skips the entry.
    ``ranges=(starts, counts)`` [T] gives each tile's stream range itself,
    in place of ``offsets`` and the cut (the dense layout: tile t owns
    slots t·cap .. t·cap + count_t)."""
    tw, th = math.ceil(image_width / tile_size), math.ceil(image_height / tile_size)
    P = tile_size * tile_size
    T_total = n_images * tw * th
    fids = None if flatten_ids is None else flatten_ids.to(torch.int64)

    if ranges is None:
        offs = offsets.to(torch.int64)
        starts = offs[:-1]
        counts = torch.clamp(offs[1:] - starts, 0, max_entries_per_tile(tile_capacity))
    else:
        starts, counts = (r.to(torch.int64) for r in ranges)
    device = starts.device
    p = torch.arange(P, device=device)
    pxl = (p % tile_size).to(torch.float32) + 0.5
    pyl = (p // tile_size).to(torch.float32) + 0.5

    L_all = int(counts.max()) if T_total else 0
    chunk = max(1, budget // (P * max(L_all, 1)))
    for t0 in range(0, T_total, chunk):
        tt = torch.arange(t0, min(t0 + chunk, T_total), device=device)
        cnt = counts[tt]
        L = int(cnt.max())
        if L == 0:
            continue
        lane = torch.arange(L, device=device)
        valid = lane[None, :] < cnt[:, None]  # [n, L]
        idx = torch.where(valid, starts[tt, None] + lane[None, :], 0)
        ids = idx if fids is None else torch.where(valid, fids[idx], 0)

        t_in = tt % (tw * th)
        px = ((t_in % tw) * tile_size)[:, None] + pxl[None, :]  # [n, P]
        py = ((t_in // tw) * tile_size)[:, None] + pyl[None, :]
        sigma, op, geom = response(tt, idx, ids, px, py)
        vis = torch.exp(-sigma)
        op_vis = op * vis
        alpha = torch.clamp(op_vis, max=ALPHA_CLAMP)
        skip = (sigma < 0.0) | (alpha < ALPHA_THRESHOLD) | ~valid[:, None, :]
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

        raw = torch.cumprod(1.0 - alpha, dim=-1)  # transmittance after each entry
        T_prev = torch.cat([torch.ones_like(raw[..., :1]), raw[..., :-1]], dim=-1)
        yield _Chunk(tt, cnt, valid, idx, ids, px, py, geom, vis, op_vis, alpha, skip,
                     raw > TRANSMITTANCE_EPS, T_prev)


def _response_3dgs(means2d, conics, opacities):
    """σ = ½(a·dx² + c·dy²) + b·dx·dy of the 3DGS walk; geom is (dx, dy,
    (a, b, c))."""
    m2 = means2d.reshape(-1, 2)
    con = conics.reshape(-1, 3)
    op = opacities.reshape(-1)

    def response(tt, idx, ids, px, py):
        dx = m2[ids, 0][:, None, :] - px[:, :, None]  # [n, P, L]
        dy = m2[ids, 1][:, None, :] - py[:, :, None]
        ca, cb, cc = (con[ids, k][:, None, :] for k in range(3))
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        return sigma, op[ids][:, None, :], (dx, dy, (ca, cb, cc))

    return response


def walked_evaluations(c: _Chunk, image_width: int, image_height: int) -> torch.Tensor:
    """[2]: the (pixel, entry) evaluations a front-to-back walk with
    per-pixel early exit makes over chunk ``c`` (every included entry plus
    the one that ends it), and the live ones among them (included and past
    the σ and 1/255 tests: the only ones that reach the colours or the
    gradients), for the pixels inside the image."""
    n_incl = (c.included & c.valid[:, None, :]).sum(-1)  # [n, P]
    walked = torch.minimum(n_incl + 1, c.cnt[:, None])
    n_live = (c.included & ~c.skip).sum(-1)
    inside = (c.px < image_width) & (c.py < image_height)
    return torch.stack([torch.where(inside, x, torch.zeros_like(x)).sum()
                        for x in (walked, n_live)])


def untile(x, I, tw, th, tile_size, image_height, image_width):
    """Tile-major [I·th·tw, P, C] → [I, H, W, C]."""
    C = x.shape[-1]
    img = x.reshape(I, th, tw, tile_size, tile_size, C)
    img = img.permute(0, 1, 3, 2, 4, 5).reshape(I, th * tile_size, tw * tile_size, C)
    return img[:, :image_height, :image_width]


def _plain_composite(
    means2d, conics, colors, opacities, image_width, image_height, tile_size,
    offsets, flatten_ids, tile_capacity, budget=1 << 24,
):
    """Composite every tile; returns (colors [I, H, W, D], T [I, H, W],
    ``walked_evaluations`` summed over the tiles)."""
    _, I, N, D, _, _ = _dims(means2d, colors, image_width, image_height, tile_size)
    walk = _plain_walk(I, image_width, image_height, tile_size, offsets, flatten_ids,
                       tile_capacity, budget, _response_3dgs(means2d, conics, opacities))
    return composite_walk(walk, colors.reshape(I * N, D), I, image_width, image_height,
                          tile_size)


def composite_walk(walk, col, n_images, image_width, image_height, tile_size):
    """The 3DGS plain forward over a plain walk whose entries' colours are
    ``col[ids]``: (colors [I, H, W, D], T [I, H, W], ``walked_evaluations``
    summed over the tiles)."""
    tw, th = math.ceil(image_width / tile_size), math.ceil(image_height / tile_size)
    device = col.device
    P = tile_size * tile_size
    T_total = n_images * tw * th
    out_c = torch.zeros((T_total, P, col.shape[1]), dtype=torch.float32, device=device)
    out_T = torch.ones((T_total, P, 1), dtype=torch.float32, device=device)
    n_evals = torch.zeros(2, dtype=torch.int64, device=device)
    for c in walk:
        alpha, included = c.alpha, c.included
        w = torch.where(included, alpha * c.T_prev, torch.zeros_like(alpha))
        out_c[c.tt] = torch.bmm(w, col[c.ids])
        out_T[c.tt, :, 0] = torch.where(included, 1.0 - alpha,
                                        torch.ones_like(alpha)).prod(-1)
        n_evals += walked_evaluations(c, image_width, image_height)

    args = (n_images, tw, th, tile_size, image_height, image_width)
    return untile(out_c, *args), untile(out_T, *args)[..., 0], n_evals


def _finish(img, alp, backgrounds, image_dims, I, D):
    """Background blend and the caller's leading dims."""
    if backgrounds is not None:
        img = img + (1.0 - alp) * backgrounds.reshape(I, 1, 1, D)
    H, W = img.shape[1:3]
    return img.reshape(image_dims + (H, W, D)), alp.reshape(image_dims + (H, W, 1))


def rasterize_to_pixels_packed_inference_plain(
    means2d: torch.Tensor,  # [..., N, 2]
    conics: torch.Tensor,  # [..., N, 3]
    colors: torch.Tensor,  # [..., N, D]
    opacities: torch.Tensor,  # [..., N]
    image_width: int,
    image_height: int,
    tile_size: int,
    offsets: torch.Tensor,  # [T+1] int32
    flatten_ids: torch.Tensor,  # [L] int32
    backgrounds: Optional[torch.Tensor] = None,  # [..., D]
    tile_capacity: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: gathers each tile's cut range and
    composites with a ``cumprod`` prefix. Returns (colors [..., H, W, D],
    alphas [..., H, W, 1])."""
    image_dims, I, _, D, _, _ = _dims(
        means2d, colors, image_width, image_height, tile_size
    )
    img, trans, _ = _plain_composite(
        means2d, conics, colors, opacities, image_width, image_height,
        tile_size, offsets, flatten_ids, tile_capacity,
    )
    return _finish(img, (1.0 - trans)[..., None], backgrounds, image_dims, I, D)


def pixel_entry_evaluations(
    means2d, conics, colors, opacities, image_width, image_height, tile_size,
    offsets, flatten_ids, tile_capacity: int = 1024,
) -> Tuple[int, int]:
    """(pixel, entry) evaluations a front-to-back walk with per-pixel early
    exit needs on these inputs, and the live ones among them
    (``walked_evaluations``): the work counts behind the kernels' bounds."""
    walked, live = _plain_composite(
        means2d, conics, colors, opacities, image_width, image_height,
        tile_size, offsets, flatten_ids, tile_capacity,
    )[2].tolist()
    return walked, live


def _check(name, t, dtype, device, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _launch(fn, name, *args):
    """Call a kernel's C entry on the current stream of ``args[0]``'s
    device (tensors as pointers, None as null), raise on its
    cudaError_t, count the launch."""
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream(args[0].device).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                 stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    _build.count_launch(name)


def _device_kind(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _load_fwd():
    lib = _build.load(KERNEL)
    fn = lib.tdgs_rasterize_packed_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _load_bwd():
    lib = _build.load(KERNEL_BWD)
    fn = lib.tdgs_rasterize_packed_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_int64, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_stream(means2d, conics, colors, opacities, image_width, image_height,
                  tile_size, offsets, flatten_ids):
    """Checks the kernels' common inputs; returns the dims."""
    device = means2d.device
    image_dims, I, N, D, tw, th = _dims(
        means2d, colors, image_width, image_height, tile_size
    )
    _check("means2d", means2d, torch.float32, device, image_dims + (N, 2))
    _check("conics", conics, torch.float32, device, image_dims + (N, 3))
    _check("colors", colors, torch.float32, device, image_dims + (N, D))
    _check("opacities", opacities, torch.float32, device, image_dims + (N,))
    _check("offsets", offsets, torch.int32, device, (I * tw * th + 1,))
    _check("flatten_ids", flatten_ids, torch.int32, device)
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(f"colors: 1..{MAX_CHANNELS} channels supported, got {D}")
    if not 1 <= tile_size * tile_size <= 1024 or (tile_size * tile_size) % 32:
        raise ValueError(f"tile_size {tile_size}: one thread per pixel, whole "
                         "warps, at most 1024")
    return image_dims, I, N, D, tw, th


def _launch_fwd(means2d, conics, colors, opacities, image_width, image_height,
                tile_size, offsets, flatten_ids, backgrounds, tile_capacity,
                write_transmittance):
    """Kernel 1 on CUDA tensors → (colors [I, H, W, D], alphas or, with
    ``write_transmittance``, T [I, H, W, 1])."""
    device = means2d.device
    image_dims, I, N, D, tw, th = _check_stream(
        means2d, conics, colors, opacities, image_width, image_height,
        tile_size, offsets, flatten_ids,
    )
    if backgrounds is not None:
        _check("backgrounds", backgrounds, torch.float32, device, image_dims + (D,))
    out_c = torch.empty((I, image_height, image_width, D), dtype=torch.float32,
                        device=device)
    out_a = torch.empty((I, image_height, image_width, 1), dtype=torch.float32,
                        device=device)
    fn = _load_fwd()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            means2d.data_ptr(), conics.data_ptr(), opacities.data_ptr(),
            colors.data_ptr(), offsets.data_ptr(), flatten_ids.data_ptr(),
            None if backgrounds is None else backgrounds.data_ptr(),
            out_c.data_ptr(), out_a.data_ptr(),
            I, image_width, image_height, tile_size, tw, th, D,
            max_entries_per_tile(tile_capacity), int(write_transmittance), stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL}: CUDA launch failed with cudaError_t {err}")
    _build.count_launch(KERNEL)
    return out_c, out_a


def rasterize_to_pixels_packed_inference(
    means2d: torch.Tensor,  # [..., N, 2]
    conics: torch.Tensor,  # [..., N, 3]
    colors: torch.Tensor,  # [..., N, D]
    opacities: torch.Tensor,  # [..., N]
    image_width: int,
    image_height: int,
    tile_size: int,
    offsets: torch.Tensor,  # [T+1] int32
    flatten_ids: torch.Tensor,  # [L] int32
    backgrounds: Optional[torch.Tensor] = None,  # [..., D]
    tile_capacity: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only packed rasterization → (colors [..., H, W, D],
    alphas [..., H, W, 1]).

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take the
    plain version. Inputs must be contiguous float32 (ids/offsets int32)
    on one device."""
    device = means2d.device
    if device.type == "cpu":
        return rasterize_to_pixels_packed_inference_plain(
            means2d, conics, colors, opacities, image_width, image_height,
            tile_size, offsets, flatten_ids, backgrounds, tile_capacity,
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    image_dims = tuple(means2d.shape[:-2])
    out_c, out_a = _launch_fwd(
        means2d, conics, colors, opacities, image_width, image_height,
        tile_size, offsets, flatten_ids, backgrounds, tile_capacity, False,
    )
    H, W, D = image_height, image_width, colors.shape[-1]
    return out_c.reshape(image_dims + (H, W, D)), out_a.reshape(image_dims + (H, W, 1))


# ---------------------------------------------------------------------------
# Training: kernel 1 (forward) and kernel 2 (backward) behind autograd
# ---------------------------------------------------------------------------


def rasterize_packed_train_fwd_plain(
    means2d, conics, colors, opacities, image_width, image_height, tile_size,
    offsets, flatten_ids, tile_capacity: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the training forward: (colors [I, H, W, D]
    without background, final transmittance T [I, H, W])."""
    img, trans, _ = _plain_composite(
        means2d, conics, colors, opacities, image_width, image_height,
        tile_size, offsets, flatten_ids, tile_capacity,
    )
    return img, trans


def rasterize_packed_train_fwd(
    means2d, conics, colors, opacities, image_width, image_height, tile_size,
    offsets, flatten_ids, tile_capacity: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward → (colors [I, H, W, D] without background, T
    [I, H, W]). CUDA tensors launch kernel 1 with the transmittance output
    (or raise); CPU tensors take the plain version."""
    device = means2d.device
    if device.type == "cpu":
        return rasterize_packed_train_fwd_plain(
            means2d, conics, colors, opacities, image_width, image_height,
            tile_size, offsets, flatten_ids, tile_capacity,
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out_c, out_t = _launch_fwd(
        means2d, conics, colors, opacities, image_width, image_height,
        tile_size, offsets, flatten_ids, None, tile_capacity, True,
    )
    return out_c, out_t[..., 0]


def tile_pixels(values, I, tw, th, tile_size):
    """Per-pixel values [I, H, W, C] → tile-major [T, P, C], zero outside
    the image."""
    H, W, C = values.shape[1:]
    pad = values.new_zeros((I, th * tile_size, tw * tile_size, C))
    pad[:, :H, :W] = values
    blocks = pad.reshape(I, th, tile_size, tw, tile_size, C).permute(0, 1, 3, 2, 4, 5)
    return blocks.reshape(I * th * tw, tile_size * tile_size, C)


def rasterize_packed_bwd_plain(
    means2d, conics, colors, opacities, image_width, image_height, tile_size,
    offsets, flatten_ids, out_colors, out_T, v_colors, v_T,
    tile_capacity: int = 1024, budget: int = 1 << 22,
) -> torch.Tensor:
    """The plain version of kernel 2: per-entry gradient rows [L, 6 + D] in
    stream order, ``[d mx, d my, d a, d b, d c, d op, d colors]`` summed over
    each entry's tile, zero for entries past the cut, past the cutoff or
    past offsets[-1]. ``out_colors``/``out_T`` are the training forward's
    outputs, ``v_colors``/``v_T`` their cotangents."""
    _, I, N, D, _, _ = _dims(means2d, colors, image_width, image_height, tile_size)
    walk = _plain_walk(I, image_width, image_height, tile_size, offsets, flatten_ids,
                       tile_capacity, budget, _response_3dgs(means2d, conics, opacities))
    v_rows = torch.zeros((flatten_ids.shape[0], 6 + D), dtype=torch.float32,
                         device=means2d.device)
    backward_walk(walk, colors.reshape(I * N, D), I, image_width, image_height, tile_size,
                  out_colors, out_T, v_colors, v_T, v_rows)
    return v_rows


def backward_walk(walk, col, n_images, image_width, image_height, tile_size,
                  out_colors, out_T, v_colors, v_T, v_rows):
    """The 3DGS plain backward over a plain walk whose entries' colours are
    ``col[ids]``: writes each walked entry's row ``[d mx, d my, d a, d b,
    d c, d op, d colors]`` into ``v_rows`` [stream, 6 + D] at its stream
    position, from the forward's ``out_colors`` [I, H, W, D] and ``out_T``
    [I, H, W] and their cotangents."""
    I, D = n_images, col.shape[1]
    tw, th = math.ceil(image_width / tile_size), math.ceil(image_height / tile_size)
    # per-pixel inputs, tile-major; pixels outside the image contribute 0
    vcol_img = v_colors.reshape(I, image_height, image_width, D)
    totq_img = (vcol_img * out_colors.reshape(I, image_height, image_width, D)).sum(
        -1, keepdim=True)
    va_img = (-v_T * out_T).reshape(I, image_height, image_width, 1)
    vcol_t, totq_t, va_t = (tile_pixels(x, I, tw, th, tile_size)
                            for x in (vcol_img, totq_img, va_img))

    for c in walk:
        tt, valid, idx, ids = c.tt, c.valid, c.idx, c.ids
        dx, dy, (ca, cb, cc) = c.geom
        vis, op_vis, alpha, T_prev = c.vis, c.op_vis, c.alpha, c.T_prev
        live = c.included & ~c.skip
        w = torch.where(live, alpha * T_prev, torch.zeros_like(alpha))

        vcol, totq, va = vcol_t[tt], totq_t[tt], va_t[tt]  # [n, P, D|1|1]
        r = torch.bmm(vcol, col[ids].transpose(1, 2))  # [n, P, L]
        suffix = totq - torch.cumsum(w * r, dim=-1)
        ra = 1.0 / (1.0 - alpha)
        v_alpha = torch.where(live, r * T_prev - suffix * ra + va * ra,
                              torch.zeros_like(alpha))
        unclamped = op_vis <= ALPHA_CLAMP
        v_sigma = torch.where(unclamped, -op_vis * v_alpha, torch.zeros_like(alpha))
        rows = torch.cat([
            torch.stack([
                (v_sigma * (ca * dx + cb * dy)).sum(1),
                (v_sigma * (cb * dx + cc * dy)).sum(1),
                (0.5 * v_sigma * dx * dx).sum(1),
                (v_sigma * dx * dy).sum(1),
                (0.5 * v_sigma * dy * dy).sum(1),
                torch.where(unclamped, vis * v_alpha, torch.zeros_like(alpha)).sum(1),
            ], dim=-1),
            torch.bmm(w.transpose(1, 2), vcol),  # [n, L, D]
        ], dim=-1)  # [n, L, F]
        v_rows[idx[valid]] = rows[valid]


def rasterize_packed_bwd(
    means2d, conics, colors, opacities, image_width, image_height, tile_size,
    offsets, flatten_ids, out_colors, out_T, v_colors, v_T,
    tile_capacity: int = 1024,
) -> torch.Tensor:
    """Per-entry gradient rows [L, 6 + D] (see the plain version). CUDA
    tensors launch kernel 2 (or raise); CPU tensors take the plain
    version."""
    device = means2d.device
    if device.type == "cpu":
        return rasterize_packed_bwd_plain(
            means2d, conics, colors, opacities, image_width, image_height,
            tile_size, offsets, flatten_ids, out_colors, out_T, v_colors, v_T,
            tile_capacity,
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    image_dims, I, N, D, tw, th = _check_stream(
        means2d, conics, colors, opacities, image_width, image_height,
        tile_size, offsets, flatten_ids,
    )
    H, W = image_height, image_width
    _check("out_colors", out_colors, torch.float32, device, (I, H, W, D))
    _check("out_T", out_T, torch.float32, device, (I, H, W))
    _check("v_colors", v_colors, torch.float32, device, (I, H, W, D))
    _check("v_T", v_T, torch.float32, device, (I, H, W))
    L = flatten_ids.shape[0]
    v_rows = torch.empty((L, 6 + D), dtype=torch.float32, device=device)
    fn = _load_bwd()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            means2d.data_ptr(), conics.data_ptr(), opacities.data_ptr(),
            colors.data_ptr(), offsets.data_ptr(), flatten_ids.data_ptr(),
            out_colors.data_ptr(), out_T.data_ptr(), v_colors.data_ptr(),
            v_T.data_ptr(), v_rows.data_ptr(),
            I, W, H, tile_size, tw, th, D, max_entries_per_tile(tile_capacity),
            L, stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL_BWD}: CUDA launch failed with cudaError_t {err}")
    _build.count_launch(KERNEL_BWD)
    return v_rows


class _RasterizePacked(torch.autograd.Function):
    """Forward: kernel 1 (training use). Backward: kernel 2's per-entry
    rows, summed per gaussian by the segment-sum kernel (the gather-VJP of
    ``gather_rows_segsum``), plus the AbsGS columns when the tap is given."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, abs_tap, offsets,
                flatten_ids, geometry):
        width, height, tile_size, tile_capacity = geometry
        img, trans = rasterize_packed_train_fwd(
            means2d, conics, colors, opacities, width, height, tile_size,
            offsets, flatten_ids, tile_capacity,
        )
        ctx.save_for_backward(means2d, conics, colors, opacities, offsets,
                              flatten_ids, img, trans)
        ctx.geometry = geometry
        ctx.with_abs = abs_tap is not None
        return img, trans

    @staticmethod
    def backward(ctx, v_img, v_trans):
        means2d, conics, colors, opacities, offsets, flatten_ids, img, trans = (
            ctx.saved_tensors)
        width, height, tile_size, tile_capacity = ctx.geometry
        v_rows = rasterize_packed_bwd(
            means2d, conics, colors, opacities, width, height, tile_size,
            offsets, flatten_ids, img, trans, v_img.contiguous(),
            v_trans.contiguous(), tile_capacity,
        )
        I, N, D = colors.shape
        sids, perm = sort_ids(flatten_ids, offsets[-1])
        sums = segment_rows_sum(v_rows, perm, sids, I * N, abs_cols=ctx.with_abs)
        v_abs = sums[:, 6 + D:] if ctx.with_abs else None
        return (sums[:, 0:2].reshape(I, N, 2), sums[:, 2:5].reshape(I, N, 3),
                sums[:, 6:6 + D].reshape(I, N, D), sums[:, 5].reshape(I, N), v_abs,
                None, None, None)


def rasterize_to_pixels_packed(
    means2d: torch.Tensor,  # [..., N, 2]
    conics: torch.Tensor,  # [..., N, 3]
    colors: torch.Tensor,  # [..., N, D]
    opacities: torch.Tensor,  # [..., N]
    image_width: int,
    image_height: int,
    tile_size: int,
    offsets: torch.Tensor,  # [T+1] int32
    flatten_ids: torch.Tensor,  # [L] int32
    backgrounds: Optional[torch.Tensor] = None,  # [..., D]
    tile_capacity: int = 1024,
    absgrad_dummy: Optional[torch.Tensor] = None,  # [I*N, 2] zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable packed rasterization (port of
    ``tdgs/ops/rasterize_pallas_packed.py:223``) → (colors [..., H, W, D],
    alphas [..., H, W, 1]).

    Gradients reach means2d, conics, colors and opacities. The background
    is blended here, outside the kernel, so autograd sees it.
    ``absgrad_dummy``: zeros whose gradient is the per-gaussian sum of
    |per-entry screen-space gradients| (AbsGS, as ``absgrad_tap``)."""
    image_dims, I, N, D, _, _ = _dims(
        means2d, colors, image_width, image_height, tile_size
    )
    # [I, N, ...]: the kernels read the image count from the leading dim
    img, trans = _RasterizePacked.apply(
        means2d.reshape(I, N, 2).contiguous(),
        conics.reshape(I, N, 3).contiguous(),
        colors.reshape(I, N, D).contiguous(),
        opacities.reshape(I, N).contiguous(),
        absgrad_dummy,
        offsets, flatten_ids,
        (image_width, image_height, tile_size, tile_capacity),
    )
    alp = 1.0 - trans
    if backgrounds is not None:
        img = img + (1.0 - alp)[..., None] * backgrounds.reshape(I, 1, 1, D)
    H, W = image_height, image_width
    return img.reshape(image_dims + (H, W, D)), alp.reshape(image_dims + (H, W, 1))
