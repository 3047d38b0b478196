"""Gaussian-splat PLY I/O (numpy copy of ``tdgs/utils/ply.py`` save_ply /
load_ply and ``morton_sort_centers``, so the port never imports the JAX
package).

Binary little-endian PLY in the standard 3DGS layout:
x y z nx ny nz f_dc_0..2 f_rest_* opacity scale_0..2 rot_0..3, raw
(pre-activation) values.
"""

from __future__ import annotations

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
