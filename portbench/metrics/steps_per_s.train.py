"""Training steps a second by the host's clock: the window's steps over
its seconds, synchronised at both ends (the traced run's window, which runs
without a tracer)."""


def read(ctx):
    n, s = ctx.get("window_units"), ctx.get("window_s")
    if not n or not s:
        return None
    return n / s
