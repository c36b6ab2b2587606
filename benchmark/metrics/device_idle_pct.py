"""100 x (1 - union of device events / the traced steps' wall) (%)."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_us"] <= 0 or not t["device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])
