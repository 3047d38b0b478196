"""Tile intersection + depth sorting (PyTorch port of
``tdgs/ops/tiling.py``: the packed stream ``isect_tiles_packed`` :154, the
dense buffers ``isect_tiles`` :43, and the footprint count behind
``derive_isect_capacity`` :485).

The contracts are the JAX package's. Packed: one int32 key
``(image*n_tiles + tile) << depth_bits | qdepth`` per (gaussian, tile)
entry, sorted, with per-tile ranges ``offsets[t]..offsets[t+1]``. Dense:
int32 keys ``image*n_tiles + tile`` ordered by float32 depth within a key,
at a fixed capacity. What differs is what PyTorch allows: shapes may
depend on the data, so only the real entries are built and sorted, and the
sorted buffers are padded with sentinel keys to the length the JAX package
would give (``N*K`` for the capped expansion, ``capacity`` otherwise).
``n_isects`` and ``n_dropped`` come back as Python ints.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from tdgs_torch._device import DeviceLike, as_float, constant, resolve_device
from tdgs_torch.ops.projection import fully_fused_projection

INT32_SENTINEL = 2**31 - 1


class IsectResult(NamedTuple):
    """Dense intersection buffers, length ``capacity``, sorted by (key,
    depth); entries past ``n_isects`` are padding (sentinel key, +inf
    depth, id 0)."""

    tiles_per_gauss: torch.Tensor  # [..., N] int32: covered tiles before the cap
    isect_keys: torch.Tensor  # [capacity] int32: image * n_tiles + tile
    isect_depths: torch.Tensor  # [capacity] float32
    flatten_ids: torch.Tensor  # [capacity] int32: image * N + gaussian
    n_isects: int
    n_dropped: int


class IsectPacked(NamedTuple):
    """Packed-key intersection buffers."""

    isect_keys: torch.Tensor  # [L] int32 sorted: tile<<depth_bits | qdepth
    flatten_ids: torch.Tensor  # [L] int32: image*N + gaussian
    offsets: torch.Tensor  # [I*tile_h*tile_w + 1] int32 per-tile ranges
    n_isects: int
    n_dropped: int
    depth_bits: int


def _round_up_128(n: int) -> int:
    return -(-n // 128) * 128


def _tile_bboxes(means2d_f, radii_f, tile_size, tile_width, tile_height):
    """Per-gaussian tile bbox [min, max) clipped to the grid, and liveness."""
    tile_means = means2d_f / tile_size
    tile_radii = radii_f / tile_size
    lim = constant((float(tile_width), float(tile_height)), means2d_f.device)
    # clip in float before the cast: a far-off mean must not wrap an int32
    zero = torch.zeros((), dtype=means2d_f.dtype, device=means2d_f.device)
    tile_mins = torch.minimum(
        torch.maximum(torch.floor(tile_means - tile_radii), zero), lim
    ).to(torch.int32)
    tile_maxs = torch.minimum(
        torch.maximum(torch.ceil(tile_means + tile_radii), zero), lim
    ).to(torch.int32)
    alive = (radii_f > 0.0).all(dim=-1)
    return tile_mins, tile_maxs, alive


def _tiles_full(means2d, radii, tile_size, tile_width, tile_height):
    """Per gaussian of the flattened [I, N] images: (tile mins [I, N, 2],
    bbox widths [I, N], covered tiles [I, N] (0 where a radius is not
    positive), liveness [I, N])."""
    N = means2d.shape[-2]
    I = math.prod(means2d.shape[:-2]) if means2d.shape[:-2] else 1
    means2d_f = means2d.reshape(I, N, 2)
    tile_mins, tile_maxs, alive = _tile_bboxes(
        means2d_f, radii.reshape(I, N, 2).to(means2d_f.dtype), tile_size, tile_width,
        tile_height)
    w_g = tile_maxs[..., 0] - tile_mins[..., 0]
    h_g = tile_maxs[..., 1] - tile_mins[..., 1]
    return tile_mins, w_g, torch.where(alive, w_g * h_g, torch.zeros_like(w_g)), alive


def orderable_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 → int64 in [0, 2^32) whose integer order is the float
    order: the bits as a signed int32, magnitude bits flipped for negative
    floats (so −0.0 sorts just before +0.0 and −inf first, as ``lax.sort``'s
    total order puts them), then shifted up by 2^31. NaNs sort past +inf."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b) + 2**31


def isect_tiles(
    means2d: torch.Tensor,  # [..., N, 2]
    radii: torch.Tensor,  # [..., N, 2]
    depths: torch.Tensor,  # [..., N]
    tile_size: int,
    tile_width: int,
    tile_height: int,
    capacity: int,
    max_tiles_per_gauss: int = 32,
    sort: bool = True,
) -> IsectResult:
    """Sorted (tile, depth) intersection buffers at a fixed capacity (port
    of ``tdgs/ops/tiling.py:43 isect_tiles``).

    Each gaussian keeps the first ``max_tiles_per_gauss`` tiles of its
    bbox in row-major order; entries are enumerated image, gaussian, tile
    (the JAX package's cumsum order), and those past ``capacity`` in that
    order are dropped before the sort. ``n_dropped`` counts both cuts. The
    sort is one stable ``torch.sort`` of ``key << 32 | orderable_bits(depth)``,
    which orders as ``lax.sort``'s stable two-key (key, depth) sort does, so
    ``flatten_ids`` agree slot for slot. ``sort=False`` keeps the
    enumeration order."""
    device = means2d.device
    image_dims = tuple(means2d.shape[:-2])
    N = means2d.shape[-2]
    tile_mins, w_g, tiles_full, _ = _tiles_full(
        means2d, radii, tile_size, tile_width, tile_height)
    G = tiles_full.numel()
    tiles_capped = torch.clamp(tiles_full, max=max_tiles_per_gauss).reshape(-1).to(torch.int64)
    total = int(tiles_capped.sum())
    n_isects = min(total, capacity)
    n_dropped = int((tiles_full.reshape(-1) - tiles_capped).sum()) + max(total - capacity, 0)

    owner = torch.repeat_interleave(
        torch.arange(G, device=device), tiles_capped, output_size=total)[:n_isects]
    k_in = torch.arange(n_isects, device=device) - (
        torch.cumsum(tiles_capped, 0) - tiles_capped)[owner]
    mins_o = tile_mins.reshape(G, 2).to(torch.int64)[owner]
    w_o = torch.clamp(w_g.reshape(-1).to(torch.int64)[owner], min=1)
    dy = k_in // w_o
    keys = ((owner // N) * (tile_width * tile_height)
            + (mins_o[:, 1] + dy) * tile_width + mins_o[:, 0] + k_in - dy * w_o)
    deps = depths.reshape(G).to(torch.float32)[owner]
    if sort:
        order = torch.sort((keys << 32) | orderable_bits(deps), stable=True).indices
        keys, deps, owner = keys[order], deps[order], owner[order]

    keys_s = torch.full((capacity,), INT32_SENTINEL, dtype=torch.int32, device=device)
    deps_s = torch.full((capacity,), float("inf"), dtype=torch.float32, device=device)
    fids_s = torch.zeros((capacity,), dtype=torch.int32, device=device)
    keys_s[:n_isects] = keys.to(torch.int32)
    deps_s[:n_isects] = deps
    fids_s[:n_isects] = owner.to(torch.int32)
    return IsectResult(
        tiles_per_gauss=tiles_full.reshape(image_dims + (N,)).to(torch.int32),
        isect_keys=keys_s, isect_depths=deps_s, flatten_ids=fids_s,
        n_isects=n_isects, n_dropped=n_dropped,
    )


def count_isects(
    means2d: torch.Tensor,  # [..., N, 2]
    radii: torch.Tensor,  # [..., N, 2]
    tile_size: int,
    tile_width: int,
    tile_height: int,
    max_tiles_per_gauss: Optional[int] = None,
) -> Tuple[int, int]:
    """(capped, full) tile-intersection counts of a projected scene (port
    of ``tdgs/ops/tiling.py:449``); ``capped`` applies the per-gaussian
    ``max_tiles_per_gauss`` clamp (None: exact coverage, capped = full)."""
    tiles_full = _tiles_full(means2d, radii, tile_size, tile_width, tile_height)[2]
    full = int(tiles_full.sum())
    if max_tiles_per_gauss is None:
        return full, full
    return int(torch.clamp(tiles_full, max=max_tiles_per_gauss).sum()), full


@torch.no_grad()
def derive_isect_capacity(
    means,
    quats,
    scales,
    opacities,
    viewmats,
    Ks,
    width: int,
    height: int,
    tile_size: int = 16,
    max_tiles_per_gauss: Optional[int] = 16,
    headroom: float = 1.1,
    device: DeviceLike = None,
    **proj_kwargs,
) -> int:
    """``isect_capacity`` for a scene (port of ``tdgs/ops/tiling.py:485``):
    the port's projection and the footprint count, ``headroom`` times the
    capped count rounded up to a multiple of 4096 (at least 4096). Waits
    for the device: call it once per scene, not per step. Runs on the card
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    radii, means2d, _, _, _ = fully_fused_projection(
        *(as_float(x, dev) for x in (means, quats, scales, viewmats, Ks)),
        width, height, opacities=as_float(opacities, dev), **proj_kwargs,
    )
    capped, _ = count_isects(
        means2d, radii, tile_size, math.ceil(width / tile_size),
        math.ceil(height / tile_size), max_tiles_per_gauss=max_tiles_per_gauss,
    )
    return max(-(-int(capped * headroom) // 4096) * 4096, 4096)


def isect_tiles_packed(
    means2d: torch.Tensor,  # [..., N, 2]
    radii: torch.Tensor,  # [..., N, 2]
    depths: torch.Tensor,  # [..., N]
    tile_size: int,
    tile_width: int,
    tile_height: int,
    max_tiles_per_gauss: int = 16,
    capacity: Optional[int] = None,
    exact: bool = False,
    exact_depth: bool = False,
    split_k: Optional[int] = None,
    big_capacity: Optional[int] = None,
) -> IsectPacked:
    """Sorted (tile, depth) intersection stream.

    - capped (default): each gaussian keeps the first ``max_tiles_per_gauss``
      tiles of its bbox in row-major order; the rest count in ``n_dropped``.
    - ``exact=True``: every covered tile, no cap; ``max_tiles_per_gauss``
      only sizes the default capacity ``I*N*K``, and demand beyond the
      capacity drops the tail in gaussian-id order.
    - ``exact_depth=True``: order within a tile by the full float32 depth
      (one int64 sort key ``tile << 32 | depth bits``) instead of the
      quantized low key bits.
    - ``capacity``: the sorted stream is cut to ``capacity`` entries
      (rounded up to 128), dropping real entries from the highest tiles.
    """
    if split_k is not None or big_capacity is not None:
        raise NotImplementedError(
            "split_k/big_capacity are not ported yet (ROADMAP queue 1, slice-1 remainders)"
        )
    device = means2d.device
    image_dims = means2d.shape[:-2]
    N = means2d.shape[-2]
    I = math.prod(image_dims) if image_dims else 1
    K = max_tiles_per_gauss
    n_tiles = tile_width * tile_height

    tile_bits = max(int(math.ceil(math.log2(max(I * n_tiles, 2)))), 1)
    depth_bits = 0 if exact_depth else 31 - tile_bits
    if not exact_depth and depth_bits < 8:
        raise ValueError(f"too many tiles ({I * n_tiles}) for packed keys")
    # top value reserved: the last tile's max-depth key must stay below the
    # sentinel, or the entry would be taken for padding
    depth_levels = max((1 << depth_bits) - 2, 1)

    depths_f = depths.reshape(I, N).to(torch.float32)
    tile_mins, w_g, tiles_full, alive = _tiles_full(
        means2d, radii, tile_size, tile_width, tile_height)

    G = I * N
    if exact_depth:
        qdepth = torch.zeros((G,), dtype=torch.int64, device=device)
        depth_key = orderable_bits(depths_f).reshape(-1)
    else:
        dmin = torch.min(torch.where(alive, depths_f, float("inf")))
        dmax = torch.max(torch.where(alive, depths_f, float("-inf")))
        dspan = torch.clamp(dmax - dmin, min=1e-12)
        q = (depths_f - dmin) / dspan * float(depth_levels)
        # dead gaussians can carry inf/nan here; they are never emitted
        q = torch.nan_to_num(q, nan=0.0, posinf=float(depth_levels), neginf=0.0)
        q = torch.clamp(q, -1.0, float(depth_levels) + 1.0)
        qdepth = torch.clamp(q.to(torch.int64), 0, depth_levels).reshape(-1)

    mins_g = tile_mins.reshape(G, 2).to(torch.int64)
    w_flat = w_g.reshape(-1).to(torch.int64)
    img_g = torch.arange(G, device=device) // N

    if exact:
        if capacity is None:
            capacity = I * N * K
        out_len = _round_up_128(capacity)
        counts = tiles_full.reshape(-1).to(torch.int64)
        total = int(counts.sum())
        n_isects = min(total, out_len)
        n_dropped = max(total - out_len, 0)
        owner = torch.repeat_interleave(
            torch.arange(G, device=device), counts, output_size=total
        )[:n_isects]
        starts = torch.cumsum(counts, 0) - counts
        k_in = torch.arange(n_isects, device=device) - starts[owner]
    else:
        if capacity is not None:
            capacity = _round_up_128(capacity)
        out_len = G * K if capacity is None or capacity >= G * K else capacity
        tiles_capped = torch.clamp(tiles_full, max=K).reshape(-1).to(torch.int64)
        n_real = int(tiles_capped.sum())
        n_dropped = int((tiles_full.reshape(-1) - tiles_capped).sum())
        owner = torch.repeat_interleave(
            torch.arange(G, device=device), tiles_capped, output_size=n_real
        )
        starts = torch.cumsum(tiles_capped, 0) - tiles_capped
        k_in = torch.arange(n_real, device=device) - starts[owner]
        n_isects = min(n_real, out_len)
        n_dropped += n_real - n_isects

    # row-major rank inside the owner's bbox → tile id
    w_o = torch.clamp(w_flat[owner], min=1)
    dy = k_in // w_o
    dx = k_in - dy * w_o
    tile_id = (
        img_g[owner] * n_tiles
        + (mins_g[owner, 1] + dy) * tile_width
        + mins_g[owner, 0] + dx
    )
    keys = (tile_id << depth_bits) | qdepth[owner]
    fids = owner.to(torch.int32)

    if exact_depth:
        order = torch.sort((keys << 32) | depth_key[owner], stable=True).indices
    else:
        order = torch.sort(keys.to(torch.int32), stable=True).indices
    # capped mode sorts every real entry and then cuts at the capacity;
    # exact mode already dropped the tail in gaussian-id order
    order = order[:n_isects]
    keys_s = torch.full((out_len,), INT32_SENTINEL, dtype=torch.int32,
                        device=device)
    fids_s = torch.zeros((out_len,), dtype=torch.int32, device=device)
    keys_s[:n_isects] = keys[order].to(torch.int32)
    fids_s[:n_isects] = fids[order]

    return IsectPacked(
        isect_keys=keys_s,
        flatten_ids=fids_s,
        offsets=_packed_offsets(keys_s, I, n_tiles, depth_bits),
        n_isects=n_isects,
        n_dropped=n_dropped,
        depth_bits=depth_bits,
    )


def _packed_offsets(keys_s: torch.Tensor, I: int, n_tiles: int,
                    depth_bits: int) -> torch.Tensor:
    """Per-tile start offsets into the sorted packed-key buffer."""
    boundaries = torch.clamp(
        torch.arange(I * n_tiles + 1, dtype=torch.int64, device=keys_s.device)
        << depth_bits,
        max=INT32_SENTINEL,
    ).to(torch.int32)
    return torch.searchsorted(keys_s, boundaries, side="left").to(torch.int32)


def isect_offset_encode(
    isect_keys: torch.Tensor,  # [L] sorted int32 keys (depth_bits = 0)
    I: int,
    tile_width: int,
    tile_height: int,
) -> torch.Tensor:
    """Per-tile start offsets [I, tile_height, tile_width] int32 into a
    sorted buffer of plain tile keys."""
    n_tiles = tile_width * tile_height
    queries = torch.arange(I * n_tiles, dtype=torch.int32,
                           device=isect_keys.device)
    offsets = torch.searchsorted(isect_keys, queries, side="left")
    return offsets.to(torch.int32).reshape(I, tile_height, tile_width)
