"""iters_per_solve (control layer: step/control.py, penalty.py): mean
iterations of the solves of the traced stretch."""


def read(ctx):
    s = ctx.stretch
    if s is None or s.solves == 0:
        return None
    return s.iterations / s.solves
