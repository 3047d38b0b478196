"""Tile intersection + depth sorting (PyTorch port of
``tdgs/ops/tiling.py``: the packed stream ``isect_tiles_packed`` :154 with
its two-population ``split_k`` expansion, the dense buffers ``isect_tiles``
:43, and the footprint counts behind ``derive_isect_capacity`` :485 and
``derive_isect_plan`` :539).

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
from tdgs_torch.ops.projection_ut import project_ut_for_tiles
from tdgs_torch.utils.profiler import host_read

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
    total = host_read(tiles_capped.sum(), "tile_sort", int)
    n_isects = min(total, capacity)
    n_dropped = (host_read((tiles_full.reshape(-1) - tiles_capped).sum(), "tile_sort", int)
                 + max(total - capacity, 0))

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


_SPLIT_CANDIDATES = (2, 3, 4, 6, 8, 12, 16, 24)


@torch.no_grad()
def derive_isect_plan(
    means,
    quats,
    scales,
    opacities,
    viewmats,
    Ks,
    width: int,
    height: int,
    tile_size: int = 16,
    max_tiles_per_gauss: int = 32,
    headroom: float = 1.1,
    big_budget: int = 8192,
    dense_factor: int = 3,
    device: DeviceLike = None,
    with_ut: bool = False,
    **proj_kwargs,
) -> dict:
    """The packed tiling's expansion plan from the scene's footprints (port
    of ``tdgs/ops/tiling.py:539``): :func:`footprint_plan` of the
    projection's radii. Waits for the device once: call it once per scene.
    Runs on the card unless ``device="cpu"``.

    ``with_ut`` projects through the unscented transform, as a 3DGUT render
    tiles (``proj_kwargs``: the render's camera model and its coefficients,
    ``ut_params``, ``eps2d``, the planes); otherwise through EWA. A 2DGS
    render tiles by its own projection's radii: hand those to
    :func:`footprint_plan`."""
    dev = resolve_device(device)
    means, quats, scales, opacities, viewmats, Ks = (
        as_float(x, dev) for x in (means, quats, scales, opacities, viewmats, Ks))
    if with_ut:
        radii, means2d, _, _, _ = project_ut_for_tiles(
            means, quats, scales, opacities, viewmats, Ks, width, height, **proj_kwargs)
    else:
        radii, means2d, _, _, _ = fully_fused_projection(
            means, quats, scales, viewmats, Ks, width, height, opacities=opacities,
            **proj_kwargs)
    return footprint_plan(means2d, radii, width, height, tile_size, max_tiles_per_gauss,
                          headroom, big_budget, dense_factor)


@torch.no_grad()
def footprint_plan(
    means2d: torch.Tensor,  # [..., N, 2]
    radii: torch.Tensor,  # [..., N, 2]
    width: int,
    height: int,
    tile_size: int = 16,
    max_tiles_per_gauss: int = 32,
    headroom: float = 1.1,
    big_budget: int = 8192,
    dense_factor: int = 3,
) -> dict:
    """The packed tiling's expansion plan from projected footprints:
    ``isect_capacity`` (``headroom`` times the capped count, rounded up to
    4096), ``max_tiles_per_gauss`` (the largest footprint, at most the cap),
    and ``isect_split_k`` / ``isect_big_capacity``: the smallest candidate
    split whose big gaussians fit ``big_budget``, taken only where the
    dense expansion's rows exceed the split's by ``dense_factor``/2. Two
    more keys are not rasterization options: ``footprint_kmax`` (a plan
    whose cap is below it clips the biggest splats' coverage; callers
    needing full coverage take ``isect_exact`` instead) and
    ``full_isect_demand``. Waits for the device once."""
    tiles = _tiles_full(means2d, radii, tile_size, math.ceil(width / tile_size),
                        math.ceil(height / tile_size))[2].reshape(-1).to(torch.int64)
    stats = torch.stack(
        [torch.clamp(tiles, max=max_tiles_per_gauss).sum(), tiles.sum(), tiles.max()]
        + [(tiles > k).sum() for k in _SPLIT_CANDIDATES]).tolist()
    cap_total, full_total, kmax = stats[:3]
    n_big = stats[3:]
    G = tiles.numel()
    K = max(min(kmax, max_tiles_per_gauss), 1)
    plan = {
        "isect_capacity": max(-(-int(cap_total * headroom) // 4096) * 4096, 4096),
        "max_tiles_per_gauss": K,
        "isect_split_k": None,
        "isect_big_capacity": None,
        "footprint_kmax": kmax,
        "full_isect_demand": full_total,
    }
    dense_rows = G * K
    for k1, nb in zip(_SPLIT_CANDIDATES, n_big):
        if k1 >= K:
            break
        if nb <= big_budget:
            bigcap = max(-(-int(nb * 2 + 256) // 128) * 128, 1024)
            if dense_rows > dense_factor / 2.0 * (G * k1 + bigcap * (K - k1)):
                plan["isect_split_k"] = k1
                plan["isect_big_capacity"] = bigcap
            break
    return plan


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
    tile_keep: Optional[int] = None,
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
    - ``split_k`` (capped mode, 0 < split_k < K): the two-population
      expansion. Every gaussian keeps its first ``split_k`` tiles; of those
      covering more, only the first ``big_capacity`` in gaussian order
      (default G/4, rounded up to 128) keep tiles ``split_k..K``; the
      others' tails count in ``n_dropped``. The stream is the JAX package's
      ``G·split_k + big_capacity·(K − split_k)`` entries long.
    - ``tile_keep``: the entries a tile's rasterizer keeps (its
      ``tile_capacity`` cut); the entries past it in each tile count in
      ``n_dropped`` too. Exact mode counts them from the footprints, in the
      same host read as the demand (on the full demand, before a capacity
      cut); capped mode from the sorted stream's offsets, one read more.
    """
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
        if tile_keep is None:
            total, n_cut = host_read(counts.sum(), "tile_sort", int), 0
        else:
            total, n_cut = host_read(torch.stack([counts.sum(), _tile_overflow(
                means2d, radii, tile_size, tile_width, tile_height, tile_keep)]),
                "tile_sort", torch.Tensor.tolist)
        n_isects = min(total, out_len)
        n_dropped = max(total - out_len, 0) + n_cut
        owner = torch.repeat_interleave(
            torch.arange(G, device=device), counts, output_size=total
        )[:n_isects]
        starts = torch.cumsum(counts, 0) - counts
        k_in = torch.arange(n_isects, device=device) - starts[owner]
    else:
        tiles_capped = torch.clamp(tiles_full, max=K).reshape(-1).to(torch.int64)
        if split_k is not None and 0 < split_k < K:
            # the first n_big_kept big gaussians (gaussian order) keep their
            # tails; the rest stop at split_k tiles
            n_big_kept = max(_round_up_128(G // 4 if big_capacity is None else big_capacity),
                             128)
            full_len = G * split_k + n_big_kept * (K - split_k)
            is_big = tiles_full.reshape(-1) > split_k
            keeps_tail = ~is_big | (torch.cumsum(is_big.to(torch.int64), 0) <= n_big_kept)
            tiles_capped = torch.where(keeps_tail, tiles_capped,
                                       torch.clamp(tiles_capped, max=split_k))
        else:
            full_len = G * K
        if capacity is not None:
            capacity = _round_up_128(capacity)
        out_len = full_len if capacity is None or capacity >= full_len else capacity
        n_real = host_read(tiles_capped.sum(), "tile_sort", int)
        n_dropped = host_read((tiles_full.reshape(-1) - tiles_capped).sum(), "tile_sort", int)
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
    offsets = _packed_offsets(keys_s, I, n_tiles, depth_bits)
    if tile_keep is not None and not exact:
        n_dropped += host_read(
            torch.clamp(offsets[1:] - offsets[:-1] - tile_keep, min=0).sum(), "tile_sort", int)

    return IsectPacked(
        isect_keys=keys_s,
        flatten_ids=fids_s,
        offsets=offsets,
        n_isects=n_isects,
        n_dropped=n_dropped,
        depth_bits=depth_bits,
    )


def _tile_overflow(means2d, radii, tile_size: int, tile_width: int, tile_height: int,
                   keep: int) -> torch.Tensor:
    """The entries past the first ``keep`` of each tile in the exact
    stream, summed (a device scalar): each live gaussian covers every tile
    of its bbox [min, max), so a tile's count is a 2D prefix sum of the
    bboxes' corners (+1 at (x0, y0) and (x1, y1), −1 at (x1, y0) and
    (x0, y1)), taken without building the stream."""
    N = means2d.shape[-2]
    I = math.prod(means2d.shape[:-2]) if means2d.shape[:-2] else 1
    means2d_f = means2d.reshape(I, N, 2)
    mins, maxs, alive = _tile_bboxes(means2d_f, radii.reshape(I, N, 2).to(means2d_f.dtype),
                                     tile_size, tile_width, tile_height)
    mins, maxs = mins.to(torch.int64), maxs.to(torch.int64)
    row = tile_width + 1
    base = (torch.arange(I, device=means2d.device) * ((tile_height + 1) * row))[:, None]
    one = alive.to(torch.int64).reshape(-1)
    diff = torch.zeros(I * (tile_height + 1) * row, dtype=torch.int64, device=means2d.device)
    for x, y, sign in ((mins, mins, 1), (maxs, maxs, 1), (maxs, mins, -1), (mins, maxs, -1)):
        diff.index_add_(0, (base + y[..., 1] * row + x[..., 0]).reshape(-1), sign * one)
    counts = diff.reshape(I, tile_height + 1, row).cumsum(1).cumsum(2)
    return torch.clamp(counts[:, :tile_height, :tile_width] - keep, min=0).sum()


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
