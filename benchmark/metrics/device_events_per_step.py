"""Kernel, copy and fill events on the device per traced step."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["steps"] or not t["device_events"]:
        return None
    return t["device_events"] / t["steps"]
