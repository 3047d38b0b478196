"""The device's idle share in %: 100 × (1 − the union of its operation
intervals over the traced window); None where the trace saw no device
operation."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["kernels"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
