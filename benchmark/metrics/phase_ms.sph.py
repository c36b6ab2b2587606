"""Device ms per traced step in the SPH force ops' ranges (density, xmass,
gradh, iad, divv-curlv, av-switches, momentum-energy)."""

SPH_PHASES = ("density", "xmass", "gradh", "iad", "divv-curlv", "av-switches",
              "momentum-energy")


def read(ctx):
    t = ctx["trace"]
    if not t or not t["steps"]:
        return None
    us = sum(t["phase_us"].get(p, 0.0) for p in SPH_PHASES)
    return us / 1e3 / t["steps"] if us > 0 else None
