"""replays_per_call (driver: util.ChunkGraph.run, through solver.py
SolveLoop.run_chunks and parallel/batch.py LaneLoop.run_chunk): loop
bodies replayed per solve call in the traced stretch, the sum of
``bodies`` over its ``pgf.chunk`` spans over its calls.  A chunk whose
replays stop once the status is terminal records the bodies it replayed;
one that replays all of them records ``jit_chunk``."""

from harness.spans import program_spans


def read(ctx):
    spans = program_spans(ctx.stretch)
    if spans is None:
        return None
    calls = ctx.stretch.calls
    if calls.stop <= calls.start:
        return None
    return sum(sp.attrs["bodies"] for sp in spans if sp.name == "pgf.chunk") / (calls.stop - calls.start)
