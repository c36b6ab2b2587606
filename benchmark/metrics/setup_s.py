"""Process start to the window's first step (s): imports, initial
conditions, the Simulation's construction and the warm-up steps, which
build the kernels in a fresh checkout."""


def read(ctx):
    return ctx["setup_s"]
