"""The least work a 2DGS training step needs, counted as ``work/counts``
counts the 3DGS step's: from the inputs' shapes and the reference's live
(pixel, surfel) pairs (alpha at least 1/255, the transmittance before it
still open), never from the system's own stream. Each input byte is
counted read once and each output byte written once; the time bound is
``counts.bound_seconds`` (the H100 SXM's float32 peak and HBM3 bandwidth)."""

from __future__ import annotations

from typing import Dict

from portbench.work.counts import PARAM_FLOATS

# floating-point operations per live pair: the plane intersection h_u × h_v
# from a surfel's three precomputed cross products (three multiply-adds
# over x and y: 12), u² + v² over the third component (6), the filter's
# |x − c|² (5), the minimum, exp and the opacity (3), the transmittance
# and weight (3), the multiply-adds of colour and depth (4 channels) and
# normal (3) (14), the distortion's running sums (6); backward, the
# adjoints of the same terms against the stored forward (2x the forward's)
FWD_PAIR_OPS = 49
BWD_PAIR_OPS = 98
# per surfel of the view: the centre (2), the three cross products (9),
# the opacity (1), colour and depth (4), the normal (3)
ROW_FLOATS = 2 + 9 + 1 + 4 + 3
# per pixel written: colour and depth (4), normal (3), transmittance,
# distortion and median depth (3); read by the backward: the gradients of
# the first four (9)
PIXEL_OUT = 10
PIXEL_GRAD = 9
# per surfel: the projection (the rotation from the quaternion ≈ 40, the
# camera-frame axes and centre ≈ 30, K·[axes | centre] ≈ 20, the screen box
# ≈ 30, the cross products ≈ 30) and the degree-3 SH colour (≈ 150);
# backward twice that
PROJ_SH_OPS = 300
# per pixel of the loss beyond the photometric terms: the depth map's
# normal (unprojection 6, differences 6, cross product 9, normalising 6),
# the normal term (8) and the distortion's mean (1)
DEPTH_NORMAL_OPS = 36


def composite(live_pairs: int, entries: int, n_visible: int, pixels: int,
              backward: bool = False) -> Dict[str, float]:
    """Surfel compositing of one view (kernel 5; with ``backward`` kernel 6
    and the per-surfel sum of its rows): the stream's surfel ids and each
    visible surfel's row read once, the images written once; backward also
    reads the images' gradients and writes each visible surfel's gradient
    row."""
    ops = live_pairs * (BWD_PAIR_OPS if backward else FWD_PAIR_OPS)
    nbytes = 4 * (entries + n_visible * ROW_FLOATS + pixels * PIXEL_OUT)
    if backward:
        nbytes += 4 * (pixels * PIXEL_GRAD + n_visible * ROW_FLOATS)
    return {"flops": float(ops), "bytes": float(nbytes)}


def train_step(n_gauss: int, n_visible: int, live_pairs: int, entries: int,
               pixels: int) -> Dict[str, float]:
    """One Adam step of a 2DGS render: the surfel projection and SH
    (forward and backward), the forward frame, the loss (L1 and the SSIM's
    five separable 11-tap filters, the depth map's normals, the normal and
    distortion terms, forward and backward), the backward, and Adam over
    every parameter (parameter, gradient and two moments read, parameter
    and moments written; ≈ 10 operations each)."""
    fwd = composite(live_pairs, entries, n_visible, pixels)
    bwd = composite(live_pairs, entries, n_visible, pixels, backward=True)
    params = PARAM_FLOATS * n_gauss
    flops = (fwd["flops"] + bwd["flops"] + 3 * PROJ_SH_OPS * n_gauss
             + 3 * pixels * (3 * (5 * 2 * 11 * 2 + 10) + DEPTH_NORMAL_OPS) + 10 * params)
    nbytes = (fwd["bytes"] + bwd["bytes"] + 4 * 3 * pixels * 2
              + 4 * params * (1 + 1 + 4 + 3))
    return {"flops": float(flops), "bytes": float(nbytes)}
