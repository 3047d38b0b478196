"""World-space compositing's share of its roofline on the 3DGUT training
path: the counted work of the forward and backward composite of a step
(the reference's live pairs; ``work/counts_3dgut.composite``) over the
device time, per traced step, of the kernels named below: kernel 7's
training call (its forward-only call shares the name, and the training
path makes none), kernel 8 and the per-gaussian reduction of its rows
(kernel 3)."""

from portbench.harness import kernel_seconds
from portbench.work.counts import bound_seconds

KERNELS = ("rasterize_eval3d_fwd_kernel", "rasterize_eval3d_bwd_kernel", "segment_sum_kernel")


def read(ctx):
    tr, work = ctx.get("trace"), ctx.get("work")
    if not tr or not work or not ctx.get("traced_units"):
        return None
    busy = kernel_seconds(tr, KERNELS)
    if not busy:
        return None
    per_step = busy / ctx["traced_units"]
    return 100.0 * bound_seconds(work["composite"]["flops"], work["composite"]["bytes"]) / per_step
