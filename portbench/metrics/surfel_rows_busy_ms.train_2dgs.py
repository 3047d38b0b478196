"""Device ms a step of the operations launched under the program's
``surfel_rows`` span (the surfels' feature rows and their gather into
stream order), from the tracer-on profiled steps
(``layer_split.launch_spans``); None where the program has no such span."""

from portbench.layer_split import busy_by_layer


def read(ctx):
    attr, n = ctx.get("attr"), ctx.get("attr_units")
    if not attr or not n or not any("surfel_rows" in c for c in attr["chains"]):
        return None
    return 1e3 * busy_by_layer(attr, ("surfel_rows",))["surfel_rows"] / n
