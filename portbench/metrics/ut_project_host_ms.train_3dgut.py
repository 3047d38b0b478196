"""Host ms a step inside the program's ``project`` span (the unscented
projection), over one period with the tracer on (its ``snapshot``)."""


def read(ctx):
    program = ctx.get("program")
    if not program or not program.get("steps") or "project" not in program["spans"]:
        return None
    return 1e3 * program["spans"]["project"]["incl_s"] / program["steps"]
