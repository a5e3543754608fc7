"""idle_launch (driver: SolveLoop.run_chunks, LaneLoop.run_chunk,
util.ChunkGraph.run): the device's idle time while the host was in the
program span ``pgf.chunk``, enqueuing a chunk (the copy-in and the
graph's replays, or the eager bodies, and the packing before its read),
in percent of the traced stretch."""

from harness.spans import idle_in


def read(ctx):
    return idle_in(ctx.stretch, ("pgf.chunk",))
