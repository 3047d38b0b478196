"""The whole 3DGUT training step's share of the card's peak: the least
time the step's counted work needs (``work/counts_3dgut.train_step``: the
reference's live pairs of the checked steps, the shapes of the state), over
the traced steps' mean time (the program's tracer off)."""

from portbench.work.counts import bound_seconds


def read(ctx):
    tr, work = ctx.get("trace"), ctx.get("work")
    if not tr or not work or not ctx.get("traced_units"):
        return None
    step_s = tr["window_s"] / ctx["traced_units"]
    return 100.0 * bound_seconds(work["step"]["flops"], work["step"]["bytes"]) / step_s
