"""torch.cuda.max_memory_allocated() over set-up and window, after a reset
at the start of the run (GiB)."""


def read(ctx):
    if not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 2**30
