"""Device ms of a traced step that rebuilt the lists, less the median
device ms of the traced steps that did not (the mean over the rebuilds)."""

import numpy as np


def read(ctx):
    t = ctx["trace"]
    if not t or not t["steps"]:
        return None
    us = np.asarray(t["step_us"][:len(t["rebuilt"])])
    flags = np.asarray(t["rebuilt"], bool)
    if not flags.any() or flags.all():
        return None
    return float(us[flags].mean() - np.median(us[~flags])) / 1e3
