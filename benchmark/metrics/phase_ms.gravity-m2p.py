"""Device ms per traced step in the ``sphexa/gravity-m2p`` range."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["steps"] or "gravity-m2p" not in t["phase_us"]:
        return None
    return t["phase_us"]["gravity-m2p"] / 1e3 / t["steps"]
