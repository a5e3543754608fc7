"""idle_wait (driver: the one blocking host read per chunk,
SolveLoop.run_chunks and LaneLoop.read): the device's idle time while the
host was blocked in the program span ``pgf.wait``, in percent of the
traced stretch.  With the work enqueued, this idle lies between and
inside the chunk's replays: gaps between the body's kernels."""

from harness.spans import idle_in


def read(ctx):
    return idle_in(ctx.stretch, ("pgf.wait",))
