"""The SPH force ops' least time over their ranges' device time (%): the
least time from the interacting pairs the reference counts on the traced
steps' input and the frozen per-pair counts (benchmark/costs.py)."""

from benchmark import costs

SPH_PHASES = ("density", "xmass", "gradh", "iad", "divv-curlv", "av-switches",
              "momentum-energy")


def read(ctx):
    t, p = ctx["trace"], ctx["pairs"]
    if not t or not t["steps"] or not p or ctx["device"] != "cuda":
        return None
    us = sum(t["phase_us"].get(ph, 0.0) for ph in SPH_PHASES)
    if us <= 0:
        return None
    least = costs.least_seconds(ctx["cfg"]["prop"], ctx["n"], p["pairs"], p["sym_pairs"])
    return 100.0 * least * t["steps"] / (us / 1e6)
