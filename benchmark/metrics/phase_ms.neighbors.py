"""Device ms per traced step in the ``sphexa/neighbors`` range."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["steps"] or "neighbors" not in t["phase_us"]:
        return None
    return t["phase_us"]["neighbors"] / 1e3 / t["steps"]
