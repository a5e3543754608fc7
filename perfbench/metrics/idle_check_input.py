"""idle_check_input (entry: Solver.solve's eager input check,
``eval.validate_fns`` under ``Params.validate_input``): the device's idle
time while the host was in the program span ``pgf.check_input``, in
percent of the traced stretch.  A part of ``idle_entry``."""

from harness.spans import idle_in


def read(ctx):
    return idle_in(ctx.stretch, ("pgf.check_input",))
