"""body_use (driver: solver.py SolveLoop.run_fused, util.ChunkGraph):
iterations over loop bodies replayed in the traced stretch, in percent; a
chunk replays ``jit_chunk`` bodies and reads the host once
(``util.HOST_READS["chunk"]``).  Single solves only: a lane stack's share
is the batched driver's ``lane_use``."""


def read(ctx):
    s = ctx.stretch
    if s is None or ctx.kind != "single" or s.chunk_reads == 0:
        return None
    return 100.0 * s.iterations / (s.chunk_reads * ctx.jit_chunk)
