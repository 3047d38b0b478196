"""The least work a 3DGUT training step needs, counted as ``work/counts``
counts the 3DGS step's: from the inputs' shapes and the reference's live
(pixel, gaussian) pairs (alpha at least 1/255, the transmittance before
it still open), never from the system's own stream. Each input byte is
counted read once and each output byte written once; the time bound is
``counts.bound_seconds`` (the H100 SXM's float32 peak and HBM3 bandwidth)."""

from __future__ import annotations

from typing import Dict

from portbench.work.counts import PARAM_FLOATS

# floating-point operations per live pair: r = M·d (15), g·r (5), the
# cross product (9), |g × r|² and |r|² (10), the division and the half
# (2), exp and the opacity (2), the transmittance and weight (3), the
# colour's multiply-add over 3 channels (6); backward, the adjoints of the
# same terms against the stored forward (2x the forward's)
FWD_PAIR_OPS = 52
BWD_PAIR_OPS = 104
# per gaussian of the view: M (9), g0 (3), the opacity, the colour (3)
ROW_FLOATS = 9 + 3 + 1 + 3
# per pixel: the ray's direction (3)
RAY_FLOATS = 3
# per gaussian, forward only (it only tiles): 7 sigma points through the
# camera (a rotation and translation, 15 + 3; the division and intrinsics,
# 6), the moments (≈ 30) and the radius (≈ 20)
UT_OPS = 7 * 24 + 50
# per gaussian: the feature row (the rotation from the quaternion ≈ 40,
# M and g0 ≈ 30) and the degree-3 SH colour (≈ 150); backward twice that
ROWS_SH_OPS = 220


def composite(live_pairs: int, entries: int, n_visible: int, pixels: int,
              channels: int = 3, backward: bool = False) -> Dict[str, float]:
    """World-space compositing of one view: the stream's gaussian ids, each
    visible gaussian's row and each pixel's ray read once, the image (and
    its transmittance) written once; backward also reads the image's
    gradient and writes each visible gaussian's gradient row."""
    ops = live_pairs * (BWD_PAIR_OPS if backward else FWD_PAIR_OPS)
    nbytes = 4 * (entries + n_visible * ROW_FLOATS + pixels * (RAY_FLOATS + channels + 1))
    if backward:
        nbytes += 4 * (pixels * channels + n_visible * ROW_FLOATS)
    return {"flops": float(ops), "bytes": float(nbytes)}


def train_step(n_gauss: int, n_visible: int, live_pairs: int, entries: int,
               pixels: int) -> Dict[str, float]:
    """One Adam step of a 3DGUT render: the unscented projection, the
    feature rows and SH (forward and backward), the forward frame, the loss
    (L1 and the SSIM's five separable 11-tap filters, forward and
    backward), the backward, and Adam over every parameter (parameter,
    gradient and two moments read, parameter and moments written; ≈ 10
    operations each)."""
    fwd = composite(live_pairs, entries, n_visible, pixels)
    bwd = composite(live_pairs, entries, n_visible, pixels, backward=True)
    params = PARAM_FLOATS * n_gauss
    flops = (fwd["flops"] + bwd["flops"] + UT_OPS * n_gauss + 3 * ROWS_SH_OPS * n_gauss
             + 3 * pixels * 3 * (5 * 2 * 11 * 2 + 10) + 10 * params)
    nbytes = (fwd["bytes"] + bwd["bytes"] + 4 * 3 * pixels * 2
              + 4 * params * (1 + 1 + 4 + 3))
    return {"flops": float(flops), "bytes": float(nbytes)}
