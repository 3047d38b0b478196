"""Surfel compositing's share of its roofline on the 2DGS training path:
the counted work of the forward and backward composite of a step (the
reference's live pairs; ``work/counts_2dgs.composite``) over the device
time, per traced step, of the kernels named below: kernel 5 (the training
forward; the inference kernel 4 shares its name, and the training path
makes no such call), kernel 6 and the per-surfel reduction of its rows
(kernel 3)."""

from portbench.harness import kernel_seconds
from portbench.work.counts import bound_seconds

KERNELS = ("rasterize_2dgs_fwd_kernel", "rasterize_2dgs_bwd_kernel", "segment_sum_kernel")


def read(ctx):
    tr, work = ctx.get("trace"), ctx.get("work")
    if not tr or not work or not ctx.get("traced_units"):
        return None
    busy = kernel_seconds(tr, KERNELS)
    if not busy:
        return None
    per_step = busy / ctx["traced_units"]
    return 100.0 * bound_seconds(work["composite"]["flops"], work["composite"]["bytes"]) / per_step
