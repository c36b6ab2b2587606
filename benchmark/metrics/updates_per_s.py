"""Particle updates per second: particles x steps completed in the
window / the window's seconds (rebuilds, replays and host reads inside)."""


def read(ctx):
    if not ctx["step_s"] or ctx["window_s"] <= 0:
        return None
    return ctx["n"] * len(ctx["step_s"]) / ctx["window_s"]
