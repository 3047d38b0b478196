"""A trained 2DGS state on the rich scene's surfaces, drawn from a seed.

A 2DGS scene past densification holds surfels laid in the surfaces it has
found: the normal-consistency term turns each disc's normal (its
rotation's third axis) toward the surface's, to within a few degrees. The
state is the 3DGS one of ``scenes/state.py`` (means, log scales,
opacities and colours drawn from the same seed), with each rotation
replaced by one whose third axis is the normal of the surface the mean
was drawn on (the terrain's gradient, an ellipsoid's, a box face's),
tilted by a gaussian angle of ``normal_sd_deg`` a tangent axis and turned
about it by a uniform angle, both drawn from the seed. The third log
scale is kept: 2DGS does not read it.

The tilt is a trained state's, and it keeps a flat face that a camera
sees edge-on (the scene's box faces are exact planes, and a camera of the
rings can lie within millimetres of one) from holding thousands of
coplanar discs whose ray–plane intersections are all ill-conditioned."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.scenes.rich import Surfaces, terrain_z
from portbench.scenes.state import trained_state


def surface_normals(means: np.ndarray, surf: Surfaces) -> np.ndarray:
    """Unit normals [n, 3] of points laid out as ``Surfaces.sample`` lays
    them (the ground's first, then each object's share in turn), each from
    the surface its point was drawn on; the sign is not fixed."""
    n = len(means)
    n_ground = int(n * 0.55)
    out = np.empty((n, 3), np.float64)
    xy = means[:n_ground, :2]
    h = 1e-3
    dzx = (terrain_z(xy + [h, 0]) - terrain_z(xy - [h, 0])) / (2 * h)
    dzy = (terrain_z(xy + [0, h]) - terrain_z(xy - [0, h])) / (2 * h)
    out[:n_ground] = np.stack([-dzx, -dzy, np.ones_like(dzx)], -1)
    per, extra = divmod(n - n_ground, len(surf.objects))
    start = n_ground
    for j, (kind, c, he) in enumerate(surf.objects):
        m = per + (1 if j < extra else 0)
        d = (means[start:start + m] - (c + [0.0, 0.0, he[2]])) / he
        if kind == 1:
            out[start:start + m] = d / he
        else:
            face = np.abs(d).argmax(-1)
            nrm = np.zeros((m, 3))
            nrm[np.arange(m), face] = np.sign(d[np.arange(m), face])
            out[start:start + m] = nrm
        start += m
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def tangent_quats(normals: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions [n, 4] of the rotations that take the z axis to
    ``normals`` (unit, flipped into the upper half: the sign of a surfel's
    normal is its camera's to choose) after a turn of ``angles`` about it."""
    nrm = torch.where(normals[:, 2:] < 0, -normals, normals)
    # e_z → n: the half-way rotation, [1 + e_z·n, e_z × n] normalised
    align = torch.stack([1.0 + nrm[:, 2], -nrm[:, 1], nrm[:, 0], torch.zeros_like(nrm[:, 0])],
                        -1)
    align = align / align.norm(dim=-1, keepdim=True)
    w1, v1 = align[:, :1], align[:, 1:]
    w2 = torch.cos(0.5 * angles)[:, None]
    v2 = torch.zeros_like(v1)
    v2[:, 2] = torch.sin(0.5 * angles)
    w = w1 * w2 - (v1 * v2).sum(-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
    return torch.cat([w, v], -1)


def trained_surfels(n: int, seed: int, device, spec: Dict) -> Dict[str, torch.Tensor]:
    """Raw parameters of ``n`` surfels (``trained_state``'s layout), each
    laid in its surface to within ``spec["normal_sd_deg"]``."""
    state = trained_state(n, seed, device, spec)
    surf = Surfaces(seed=spec.get("scene_seed", 11), extent=spec.get("extent", 4.0))
    normals = surface_normals(state["means"].cpu().numpy().astype(np.float64), surf)
    normals = torch.as_tensor(normals, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed((seed * 7919 + 1) & 0x7FFFFFFFFFFFFFFF)
    tilt = torch.randn((n, 3), generator=g, device=device) * np.tan(
        np.deg2rad(spec["normal_sd_deg"]))
    tilt = tilt - (tilt * normals).sum(-1, keepdim=True) * normals
    normals = torch.nn.functional.normalize(normals + tilt, dim=-1)
    angles = 2.0 * np.pi * torch.rand(n, generator=g, device=device)
    return dict(state, quats=tangent_quats(normals, angles).contiguous())
