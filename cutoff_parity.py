"""How often kernel 1 and its plain version decide the 1e-4 transmittance
cutoff differently, with and without ``rasterize_packed.left_to_right``.

The kernel multiplies each pixel's running product of (1 − α) left to right
in float32; ``torch.cumprod`` on the card multiplies in a tree, so the two
products of the same factors differ by a few ulps, and where one lands on
either side of 1e-4 the entry there is included by one and not the other
(its weight α·T reaches about 1e-2 when α is large). The plain version now
recomputes every row whose product comes that close to a cutoff left to
right. For each frame the script renders kernel 1 once and the plain
version twice, as it is and with ``left_to_right`` taken out (``cumprod``
alone), and prints one JSON line per frame: the largest difference from the
kernel of each, the pixels that differ by more than 1e-5, and the rows the
repair recomputed. Frames: the bench scene (200k gaussians, 1920x1080) and
the rally's domino scene (opaque dominoes on the ground), each from the
smoke's viewer poses (its view and poses near it); then ``near_cutoff``:
4096 tiles of one row each whose product ends within 1e-6 of 1e-4 after an
entry of large α (the card tests' stream, ``tests/test_torch_kernel_card.py
cutoff_stream``).

    python3 cutoff_parity.py --frames 20

Needs a CUDA card; the port does not use this script.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import chip_smoke as smoke
from tdgs_torch.ops import rasterize_packed as R
from tests.test_torch_kernel_card import cutoff_stream, near_cutoff_opacities


def frame_errors(args, repaired):
    got = R.rasterize_to_pixels_packed_inference(*args)
    repaired.clear()
    want = R.rasterize_to_pixels_packed_inference_plain(*args)
    keep = R.left_to_right
    R.left_to_right = lambda raw, one_minus: raw
    try:
        old = R.rasterize_to_pixels_packed_inference_plain(*args)
    finally:
        R.left_to_right = keep
    out = {}
    for name, ref in (("plain", want), ("cumprod_only", old)):
        d = torch.maximum((got[0] - ref[0]).abs().amax(-1), (got[1] - ref[1]).abs()[..., 0])
        out[f"{name}_max_abs_err"] = float(d.max())
        out[f"{name}_pixels_over_1e-5"] = int((d > 1e-5).sum())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20, help="poses of each scene")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1

    repaired = []
    counting = R.left_to_right

    def count(raw, one_minus):
        before = raw.clone()
        out = counting(raw, one_minus)
        repaired.append(int((out != before).any(-1).sum()))
        return out

    R.left_to_right = count
    print(smoke.nvidia_smi(), flush=True)
    worst = {"plain": 0.0, "cumprod_only": 0.0}
    # each scene with the tiling the smoke's parity phase gives it
    scenes = {"bench": (smoke.bench_scene(), dict(max_tiles_per_gauss=16)),
              "rally": (smoke.rally_scene(), dict(isect_exact=True))}
    for name, (scene, tiling) in scenes.items():
        sc = smoke.to_card({k: v for k, v in scene.items() if k != "labels"})
        base = sc["viewmats"][0]
        for i, pose in enumerate(smoke.viewer_poses(a.frames)):
            vm = (torch.as_tensor(pose, device=smoke.DEVICE) @ base)[None]
            args, _, _ = smoke.kernel_inputs({**sc, "viewmats": vm}, **tiling)
            errs = frame_errors(args, repaired)
            rows = sum(repaired)  # the plain call's: the patched one skips the count
            for k in worst:
                worst[k] = max(worst[k], errs[f"{k}_max_abs_err"])
            print(json.dumps({"scene": name, "frame": i, "rows_recomputed": rows, **errs}),
                  flush=True)
    s = cutoff_stream(near_cutoff_opacities(np.random.default_rng(9), 4096, 1e-4))
    t = {k: v.to(smoke.DEVICE) for k, v in s.items() if torch.is_tensor(v)}
    args = (t["means2d"], t["conics"], t["colors"], t["opacities"], s["width"], s["height"],
            16, t["offsets"], t["flatten_ids"])
    errs = frame_errors(args, repaired)
    for k in worst:
        worst[k] = max(worst[k], errs[f"{k}_max_abs_err"])
    print(json.dumps({"scene": "near_cutoff", "rows_recomputed": sum(repaired), **errs}),
          flush=True)
    print(json.dumps({"worst": worst}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
