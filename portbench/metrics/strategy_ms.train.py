"""Host ms per step inside ``Runner.strategy_post_backward`` (the MCMC
noise every step, the relocation on refine steps), over the window's steps."""


def read(ctx):
    spans, n = ctx.get("spans"), ctx.get("window_units")
    if spans is None or not n or not spans.count("strategy"):
        return None
    return 1e3 * spans.total("strategy") / n
