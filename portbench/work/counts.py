"""The least work a training step needs, counted from the
inputs' shapes and from the reference's live (pixel, gaussian) pairs, and
never from the system's own stream: a change to tiling, culling or the
kernels leaves the yardstick where it is. A live pair is one that reaches
the colour: alpha at least 1/255 and the transmittance before it still
open. Each input byte is counted read once and each output byte written
once; the time bound is the larger of operations over the float32 peak
and bytes over the memory bandwidth (NVIDIA H100 SXM data sheet)."""

from __future__ import annotations

from typing import Dict

PEAK_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # bytes/s, HBM3

# floating-point operations per live pair: the conic's quadratic form (9),
# exp and the opacity (2), the transmittance and weight (3) and the
# colour's multiply-add over 3 channels (6); backward, the adjoints of the
# same terms against the stored forward (2x the forward's)
FWD_PAIR_OPS = 20
BWD_PAIR_OPS = 40
# per gaussian of the view: the 2D mean, conic, colour, opacity, depth
ROW_FLOATS = 2 + 3 + 3 + 1 + 1
# per gaussian: projection with its covariance (≈ 200) and the degree-3
# SH colour (16 bases and 48 multiply-adds ≈ 150); backward twice that
PROJ_SH_OPS = 350
# raw parameters a gaussian carries: means 3, quats 4, scales 3,
# opacity 1, SH 48
PARAM_FLOATS = 59


def bound_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)


def composite(live_pairs: int, entries: int, n_visible: int, pixels: int,
              channels: int = 3, backward: bool = False) -> Dict[str, float]:
    """Front-to-back compositing of one view: the stream's gaussian ids
    and each visible gaussian's row read once, the image written once;
    backward also reads the image's gradient and writes each visible
    gaussian's gradient row."""
    ops = live_pairs * (BWD_PAIR_OPS if backward else FWD_PAIR_OPS)
    nbytes = 4 * (entries + n_visible * ROW_FLOATS + pixels * (channels + 1))
    if backward:
        nbytes += 4 * (pixels * channels + n_visible * ROW_FLOATS)
    return {"flops": float(ops), "bytes": float(nbytes)}


def train_step(n_gauss: int, n_visible: int, live_pairs: int, entries: int,
               pixels: int) -> Dict[str, float]:
    """One Adam step of a render: the forward frame, the loss (L1 and the
    SSIM's five separable 11-tap filters, forward and backward), the
    backward, and Adam over every parameter (parameter, gradient and two
    moments read, parameter and moments written; ≈ 10 operations each)."""
    fwd = composite(live_pairs, entries, n_visible, pixels)
    bwd = composite(live_pairs, entries, n_visible, pixels, backward=True)
    params = PARAM_FLOATS * n_gauss
    flops = (fwd["flops"] + bwd["flops"] + 3 * PROJ_SH_OPS * n_gauss
             + 3 * pixels * 3 * (5 * 2 * 11 * 2 + 10) + 10 * params)
    nbytes = (fwd["bytes"] + bwd["bytes"] + 4 * 3 * pixels * 2
              + 4 * params * (1 + 1 + 4 + 3))
    return {"flops": float(flops), "bytes": float(nbytes)}
