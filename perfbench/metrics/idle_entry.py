"""idle_entry (entry: Solver.solve, BatchedSolver.solve): the device's idle
time while the host was in the program span ``pgf.prepare`` (the start's
transform, the input check, ``init_state``, the data's bind) or
``pgf.finish`` (the copies out of the graph's buffers and the result), in
percent of the traced stretch."""

from harness.spans import idle_in


def read(ctx):
    return idle_in(ctx.stretch, ("pgf.prepare", "pgf.finish"))
