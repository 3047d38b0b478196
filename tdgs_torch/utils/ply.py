"""Gaussian-splat file I/O (numpy copy of ``tdgs/utils/ply.py``, so the
port never imports the JAX package): the standard 3DGS PLY, the
antimatter15 ``.splat`` and the PlayCanvas/SuperSplat compressed PLY, and
``export_splats`` over the three.

The binary little-endian PLY has the standard 3DGS layout:
x y z nx ny nz f_dc_0..2 f_rest_* opacity scale_0..2 rot_0..3, raw
(pre-activation) values. Given the same arrays every writer gives the
JAX package's bytes.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, Optional

import numpy as np


def morton_sort_centers(means: np.ndarray) -> np.ndarray:
    """The order of ``means`` [N, 3] along a Morton (Z-order) curve over
    their bounding box at 10 bits an axis: indices, numpy's ``argsort`` of
    the codes, as the JAX package takes it."""
    lo = means.min(axis=0)
    hi = means.max(axis=0)
    q = ((means - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.uint32)

    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code)


def save_ply(
    path: str,
    means: np.ndarray,  # [N, 3]
    scales: np.ndarray,  # [N, 3] log-scales
    quats: np.ndarray,  # [N, 4] wxyz
    opacities: np.ndarray,  # [N] logits
    sh0: np.ndarray,  # [N, 1, 3]
    shN: np.ndarray,  # [N, K-1, 3]
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write the standard 3DGS binary PLY (raw/pre-activation values)."""
    n = means.shape[0]
    km1 = shN.shape[1]
    fields = ["x", "y", "z", "nx", "ny", "nz"]
    fields += [f"f_dc_{i}" for i in range(3)]
    fields += [f"f_rest_{i}" for i in range(km1 * 3)]
    fields += ["opacity"]
    fields += [f"scale_{i}" for i in range(3)]
    fields += [f"rot_{i}" for i in range(4)]
    extra = extra or {}
    extra_cols = []
    for name, arr in extra.items():
        arr = arr.reshape(n, -1)
        for i in range(arr.shape[1]):
            fields.append(f"{name}_{i}")
        extra_cols.append(arr.astype(np.float32))

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {f}\n" for f in fields)
        + "end_header\n"
    )
    # f_rest layout: channel-major (all R coeffs, all G, all B) — the Inria
    # convention (reference exporter.py splat2ply_bytes).
    sh_rest = shN.transpose(0, 2, 1).reshape(n, -1)  # [N, 3*(K-1)]
    cols = [
        means.astype(np.float32),
        np.zeros((n, 3), np.float32),
        sh0.reshape(n, 3).astype(np.float32),
        sh_rest.astype(np.float32),
        opacities.reshape(n, 1).astype(np.float32),
        scales.astype(np.float32),
        quats.astype(np.float32),
    ] + extra_cols
    data = np.concatenate(cols, axis=1)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.astype("<f4").tobytes())


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a 3DGS binary PLY into a raw-parameter dict
    (reference gsplat/utils.py:load_ply:259). Returns means, scales (log),
    quats (wxyz), opacities (logit), sh0 [N,1,3], shN [N,K-1,3], plus any
    extra float properties grouped by prefix."""
    with open(path, "rb") as f:
        blob = f.read()
    header_end = blob.index(b"end_header\n") + len(b"end_header\n")
    header = blob[:header_end].decode("ascii")
    lines = [l.strip() for l in header.splitlines()]
    n = 0
    props = []
    fmt_binary = True
    for l in lines:
        if l.startswith("format"):
            fmt_binary = "binary_little_endian" in l
        elif l.startswith("element vertex"):
            n = int(l.split()[-1])
        elif l.startswith("property float"):
            props.append(l.split()[-1])
        elif l.startswith("property") and "float" not in l:
            raise ValueError(f"unsupported property type: {l}")
    if not fmt_binary:
        raise ValueError("only binary_little_endian PLY supported")
    data = np.frombuffer(
        blob, dtype="<f4", count=n * len(props), offset=header_end
    ).reshape(n, len(props)).copy()
    col = {name: data[:, i] for i, name in enumerate(props)}

    means = np.stack([col["x"], col["y"], col["z"]], -1)
    scales = np.stack([col[f"scale_{i}"] for i in range(3)], -1)
    quats = np.stack([col[f"rot_{i}"] for i in range(4)], -1)
    opacities = col["opacity"]
    sh0 = np.stack([col[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :]
    n_rest = len([p for p in props if p.startswith("f_rest_")])
    km1 = n_rest // 3
    if n_rest:
        rest = np.stack([col[f"f_rest_{i}"] for i in range(n_rest)], -1)
        shN = rest.reshape(n, 3, km1).transpose(0, 2, 1)
    else:
        shN = np.zeros((n, 0, 3), np.float32)

    out = {
        "means": means,
        "scales": scales,
        "quats": quats,
        "opacities": opacities,
        "sh0": sh0,
        "shN": shN,
    }
    # extra property groups (e.g. identity_encodings_0..15)
    known = {p for p in props if p in ("x", "y", "z", "nx", "ny", "nz", "opacity")
             or p.startswith(("f_dc_", "f_rest_", "scale_", "rot_"))}
    extra_names = sorted({p.rsplit("_", 1)[0] for p in props if p not in known})
    for name in extra_names:
        idxs = sorted(
            (int(p.rsplit("_", 1)[1]), p)
            for p in props
            if p.startswith(name + "_") and p.rsplit("_", 1)[0] == name
        )
        out[name] = np.stack([col[p] for _, p in idxs], -1)
    return out


def load_ply_milo(path: str) -> Dict[str, np.ndarray]:
    """Name-parity variant of :func:`load_ply` (reference
    gsplat/utils.py:load_ply_milo:349): identical parse except the
    f_rest_* columns are interpreted channel-interleaved
    (``reshape(N, K-1, 3)`` directly) instead of the Inria
    coefficient-major layout. Use for PLYs written by exporters that
    store shN row-major per coefficient."""
    out = load_ply(path)
    shN = out["shN"]
    n, km1, _ = shN.shape
    if km1:
        flat = shN.transpose(0, 2, 1).reshape(n, -1)  # original column order
        out["shN"] = flat.reshape(n, km1, 3)
    return out


def save_splat(
    path: str,
    means: np.ndarray,
    scales: np.ndarray,  # log
    quats: np.ndarray,  # wxyz
    opacities: np.ndarray,  # logits
    sh0: np.ndarray,  # [N, 1, 3]
) -> None:
    """antimatter15 .splat format: 32 bytes per splat — position f32x3,
    scale f32x3, rgba u8x4, quat u8x4 (reference exporter.py:420)."""
    idx = morton_sort_centers(means)
    means = means[idx]
    scales = np.exp(scales[idx])
    quats = quats[idx]
    quats = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    op = 1.0 / (1.0 + np.exp(-opacities[idx]))
    rgb = np.clip(sh0[idx, 0] * 0.2820947917738781 + 0.5, 0, 1)

    with open(path, "wb") as f:
        for i in range(means.shape[0]):
            f.write(struct.pack("<3f", *means[i]))
            f.write(struct.pack("<3f", *scales[i]))
            rgba = (*(rgb[i] * 255).astype(np.uint8), int(op[i] * 255))
            f.write(struct.pack("<4B", *rgba))
            q = ((quats[i] * 128) + 128).clip(0, 255).astype(np.uint8)
            f.write(struct.pack("<4B", *q))


def _pack_unorm(value: np.ndarray, bits: int) -> np.ndarray:
    """Quantize [0,1] floats to `bits`-bit unsigned ints (reference
    exporter.py:pack_unorm:88)."""
    t = (1 << bits) - 1
    return np.clip(np.floor(value * t + 0.5), 0, t).astype(np.uint32)


def _pack_111011(xyz: np.ndarray) -> np.ndarray:
    """[N,3] unit floats → one uint32 with 11/10/11 bits per component."""
    return (
        (_pack_unorm(xyz[:, 0], 11) << 21)
        | (_pack_unorm(xyz[:, 1], 10) << 11)
        | _pack_unorm(xyz[:, 2], 11)
    )


def _pack_8888(xyzw: np.ndarray) -> np.ndarray:
    """[N,4] unit floats → one uint32, 8 bits per component."""
    return (
        (_pack_unorm(xyzw[:, 0], 8) << 24)
        | (_pack_unorm(xyzw[:, 1], 8) << 16)
        | (_pack_unorm(xyzw[:, 2], 8) << 8)
        | _pack_unorm(xyzw[:, 3], 8)
    )


def _pack_rotation(q: np.ndarray) -> np.ndarray:
    """Smallest-three quaternion packing: 2-bit largest-component index +
    3×10-bit remaining components scaled by √2/2 (reference
    exporter.py:pack_rotation:147). q: [N,4] (wxyz, any sign/scale)."""
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    largest = np.argmax(np.abs(q), axis=-1)
    rows = np.arange(q.shape[0])
    q = np.where((q[rows, largest] < 0)[:, None], -q, q)
    others = np.array(
        [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64
    )[largest]
    comp = q[rows[:, None], others]  # [N, 3]
    packed = _pack_unorm(comp * (math.sqrt(2) * 0.5) + 0.5, 10)
    return (
        (largest.astype(np.uint32) << 30)
        | (packed[:, 0] << 20)
        | (packed[:, 1] << 10)
        | packed[:, 2]
    )


SH_C0 = 0.28209479177387814


def save_ply_compressed(
    path: str,
    means: np.ndarray,  # [N, 3]
    scales: np.ndarray,  # [N, 3] log-scales
    quats: np.ndarray,  # [N, 4] wxyz
    opacities: np.ndarray,  # [N] logits
    sh0: np.ndarray,  # [N, 1, 3]
    shN: np.ndarray,  # [N, K-1, 3]
    chunk_size: int = 256,
    opacity_threshold: float = 1.0 / 255.0,
) -> None:
    """PlayCanvas/SuperSplat compressed PLY
    (reference exporter.py:splat2ply_bytes_compressed:194): Morton-sorted
    splats in 256-splat chunks, each chunk storing f32 min/max bounds for
    means / log-scales / colors, each splat packed into 4 uint32s
    (position 11-10-11, smallest-three rotation, scale 11-10-11,
    rgba 8888), and f_rest SH coefficients quantized to uint8.

    Vectorized over all chunks at once (no per-chunk python loop)."""
    n_all = means.shape[0]
    opac = 1.0 / (1.0 + np.exp(-np.asarray(opacities, np.float64)))
    keep = opac > opacity_threshold
    if not keep.any():
        raise ValueError(f"no splats above opacity threshold (N={n_all})")
    means = means[keep].astype(np.float32)
    scales = scales[keep].astype(np.float32)
    quats = quats[keep].astype(np.float32)
    opacities = np.asarray(opacities)[keep].astype(np.float32)
    colors = (sh0[keep].reshape(-1, 3) * SH_C0 + 0.5).astype(np.float32)
    # channel-major f_rest layout (all R coeffs, all G, all B) — the same
    # convention as the uncompressed writer (reference exporter.py:514)
    sh_rest = shN[keep].transpose(0, 2, 1).reshape(int(keep.sum()), -1)
    sh_rest = sh_rest.astype(np.float32)  # [n, 3*(K-1)]
    n = means.shape[0]
    if n == 0:
        raise ValueError(f"no splats above opacity threshold (N={n_all})")

    order = morton_sort_centers(means)
    means, scales, quats = means[order], scales[order], quats[order]
    opacities, colors, sh_rest = opacities[order], colors[order], sh_rest[order]

    n_chunks = (n + chunk_size - 1) // chunk_size
    pad = n_chunks * chunk_size - n
    # edge-pad so padded rows never move a chunk's min/max
    def padded(a):
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)

    def bounds(a):  # [n,3] → min/max [n_chunks, 3] each
        c = padded(a).reshape(n_chunks, chunk_size, 3)
        return c.min(axis=1), c.max(axis=1)

    mn_m, mx_m = bounds(means)
    mn_s, mx_s = bounds(scales)
    mn_c, mx_c = bounds(colors)
    chunk_bounds = np.concatenate(
        [mn_m, mx_m, mn_s, mx_s, mn_c, mx_c], axis=1
    ).astype("<f4")  # [n_chunks, 18]

    def normalize(a, mn, mx):
        rng = np.maximum(mx - mn, 1e-12)
        return (a - np.repeat(mn, chunk_size, axis=0)[:n]) / np.repeat(
            rng, chunk_size, axis=0
        )[:n]

    p_pos = _pack_111011(normalize(means, mn_m, mx_m))
    p_rot = _pack_rotation(quats)
    p_scl = _pack_111011(normalize(scales, mn_s, mx_s))
    rgba = np.concatenate(
        [normalize(colors, mn_c, mx_c),
         (1.0 / (1.0 + np.exp(-opacities)))[:, None]], axis=1,
    )
    p_col = _pack_8888(rgba)
    splat_words = np.stack([p_pos, p_rot, p_scl, p_col], axis=1).astype("<u4")

    sh_q = np.clip(np.trunc((sh_rest / 8.0 + 0.5) * 256.0), 0, 255).astype(
        np.uint8
    )

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element chunk {n_chunks}\n"
        + "".join(
            f"property float {p}_{a}\n"
            for p in ("min", "max") for a in ("x", "y", "z")
        )
        + "".join(
            f"property float {p}_scale_{a}\n"
            for p in ("min", "max") for a in ("x", "y", "z")
        )
        + "".join(
            f"property float {p}_{a}\n"
            for p in ("min", "max") for a in ("r", "g", "b")
        )
        + f"element vertex {n}\n"
        + "".join(
            f"property uint packed_{p}\n"
            for p in ("position", "rotation", "scale", "color")
        )
        + f"element sh {n}\n"
        + "".join(f"property uchar f_rest_{j}\n" for j in range(sh_rest.shape[1]))
        + "end_header\n"
    )
    # header property order interleaves min/max (min_x..z, max_x..z) —
    # matches the bounds concat above
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(chunk_bounds.tobytes())
        f.write(splat_words.tobytes())
        f.write(sh_q.tobytes())


def load_ply_compressed(path: str) -> Dict[str, np.ndarray]:
    """Decode a compressed PLY written by save_ply_compressed back into raw
    splat parameters (means, scales [log], quats [wxyz], opacities [logit],
    sh0 [N,1,3], shN [N,K-1,3]). Used for round-trip tests and for loading
    SuperSplat exports."""
    with open(path, "rb") as f:
        blob = f.read()
    header_end = blob.index(b"end_header\n") + len(b"end_header\n")
    header = blob[:header_end].decode("ascii")
    n_chunks = n = n_sh_props = 0
    for line in header.splitlines():
        if line.startswith("element chunk"):
            n_chunks = int(line.split()[-1])
        elif line.startswith("element vertex"):
            n = int(line.split()[-1])
        elif line.startswith("property uchar f_rest_"):
            n_sh_props += 1

    off = header_end
    bounds = np.frombuffer(blob, "<f4", n_chunks * 18, off).reshape(n_chunks, 18)
    off += n_chunks * 18 * 4
    words = np.frombuffer(blob, "<u4", n * 4, off).reshape(n, 4)
    off += n * 16
    sh_q = np.frombuffer(blob, np.uint8, n * n_sh_props, off).reshape(
        n, n_sh_props
    )

    cid = np.minimum(np.arange(n) // 256, n_chunks - 1)
    mn_m, mx_m = bounds[cid, 0:3], bounds[cid, 3:6]
    mn_s, mx_s = bounds[cid, 6:9], bounds[cid, 9:12]
    mn_c, mx_c = bounds[cid, 12:15], bounds[cid, 15:18]

    def un_111011(w):
        x = ((w >> 21) & 0x7FF).astype(np.float32) / 2047.0
        y = ((w >> 11) & 0x3FF).astype(np.float32) / 1023.0
        z = (w & 0x7FF).astype(np.float32) / 2047.0
        return np.stack([x, y, z], -1)

    means = mn_m + un_111011(words[:, 0]) * (mx_m - mn_m)
    scales = mn_s + un_111011(words[:, 2]) * (mx_s - mn_s)

    rot = words[:, 1]
    largest = (rot >> 30).astype(np.int64)
    c = np.stack(
        [((rot >> s) & 0x3FF).astype(np.float32) / 1023.0 for s in (20, 10, 0)],
        -1,
    )
    c = (c - 0.5) / (math.sqrt(2) * 0.5)
    quats = np.zeros((n, 4), np.float32)
    others = np.array(
        [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64
    )[largest]
    rows = np.arange(n)
    quats[rows[:, None], others] = c
    quats[rows, largest] = np.sqrt(
        np.maximum(0.0, 1.0 - np.sum(c * c, axis=-1))
    )

    col = words[:, 3]
    rgba = np.stack(
        [((col >> s) & 0xFF).astype(np.float32) / 255.0 for s in (24, 16, 8, 0)],
        -1,
    )
    colors = mn_c + rgba[:, :3] * (mx_c - mn_c)
    sh0 = ((colors - 0.5) / SH_C0)[:, None, :]
    op = np.clip(rgba[:, 3], 1e-6, 1.0 - 1e-6)
    opacities = np.log(op / (1.0 - op))
    shN = (
        ((sh_q.astype(np.float32) / 256.0 - 0.5) * 8.0)
        .reshape(n, 3, -1)
        .transpose(0, 2, 1)
    )
    return {
        "means": means,
        "scales": scales,
        "quats": quats,
        "opacities": opacities,
        "sh0": sh0,
        "shN": shN,
    }


def export_splats(
    means: np.ndarray,
    scales: np.ndarray,
    quats: np.ndarray,
    opacities: np.ndarray,
    sh0: np.ndarray,
    shN: np.ndarray,
    format: str = "ply",
    save_to: str = "splats.ply",
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Export splats (reference gsplat/exporter.py:export_splats:475).
    Formats: "ply" (standard 3DGS), "splat" (antimatter15),
    "ply_compressed" (PlayCanvas/SuperSplat). Arrays or tensors (on any
    device: copied to the host)."""
    means, scales, quats, opacities, sh0, shN = (
        _host(x) for x in (means, scales, quats, opacities, sh0, shN))
    if extra is not None:
        extra = {k: _host(v) for k, v in extra.items()}
    if format == "ply":
        save_ply(save_to, means, scales, quats, opacities, sh0, shN, extra)
    elif format == "splat":
        save_splat(save_to, means, scales, quats, opacities, sh0)
    elif format == "ply_compressed":
        save_ply_compressed(
            save_to, means, scales, quats, opacities, sh0, shN
        )
    else:
        raise ValueError(f"unsupported format {format!r}")


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)
