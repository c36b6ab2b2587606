"""Device ms per traced step in every ``sphexa/gravity-*`` range."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["steps"]:
        return None
    us = sum(v for k, v in t["phase_us"].items() if k.startswith("gravity-"))
    return us / 1e3 / t["steps"] if us > 0 else None
