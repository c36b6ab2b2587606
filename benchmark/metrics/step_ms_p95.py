"""The 95th percentile of the host wall time of the window's
``Simulation.step()`` calls, each ending in its read of the card (ms)."""

import numpy as np


def read(ctx):
    s = ctx["step_s"]
    if len(s) < 200:  # fewer than ten steps beyond the percentile
        return None
    return float(np.percentile(np.asarray(s) * 1e3, 95))
