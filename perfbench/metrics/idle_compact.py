"""idle_compact (batched driver: BatchedSolver._solve_compacting): the
device's idle time while the host was in the program span
``pgf.compact`` (a tier change's scatter, gather and bind, and the final
scatter), in percent of the traced stretch."""

from harness.spans import idle_in


def read(ctx):
    return idle_in(ctx.stretch, ("pgf.compact",))
