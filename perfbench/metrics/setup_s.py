"""setup_s: from the process's start to the window's first call: imports,
the CUDA context, the kernel build (first run of a checkout), the solver,
its warm solves with their graph captures, and on the card the settling
calls."""


def read(ctx):
    return ctx.setup_s
