"""Host ms per step inside ``Runner._batch`` (the batch's images: the wait
for the decode-ahead, the copies to the card), over the window's steps."""


def read(ctx):
    spans, n = ctx.get("spans"), ctx.get("window_units")
    if spans is None or not n or not spans.count("data"):
        return None
    return 1e3 * spans.total("data") / n
