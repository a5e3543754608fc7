"""lane_use (batched driver: parallel/batch.py LaneLoop and the compaction
tiers): iterations of the stretch's answers over the lane-bodies its
chunks replayed (``width * bodies`` of each ``pgf.chunk`` span), in
percent: pads and lanes past their terminal status count as replayed."""

from harness.spans import lane_bodies


def read(ctx):
    s = ctx.stretch
    replayed = lane_bodies(s)
    if not replayed:
        return None
    return 100.0 * s.iterations / replayed
