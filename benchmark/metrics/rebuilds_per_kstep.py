"""List builds (``Simulation.rebuilds``) per 1,000 window steps."""


def read(ctx):
    steps = ctx["counters"]["steps"]
    if not steps:
        return None
    return 1e3 * ctx["counters"]["rebuilds"] / steps
