"""Simulated time advanced per second: the sum of dt over the window's
completed steps / the window's seconds."""


def read(ctx):
    if not ctx["dt"] or ctx["window_s"] <= 0:
        return None
    return float(sum(ctx["dt"])) / ctx["window_s"]
