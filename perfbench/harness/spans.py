"""The program's own spans (``pygradflow_torch.util.SPANS``) read against
the device's idle time of a traced stretch.

The port records a span at each of its drivers' layer boundaries while a
``torch.profiler`` records, on the clock of the profiler's events, so a
span's interval compares directly with the stretch's device intervals
(``harness.trace.Trace``).  A program without that ring gives no spans,
and the readers below then return None.
"""

from .trace import gaps, union


def program_spans(stretch):
    """The program spans whose interval meets the traced stretch, or None
    when the program records none there (or records no spans at all)."""
    if stretch is None:
        return None
    try:
        from pygradflow_torch import util
    except ImportError:
        return None
    ring = getattr(util, "SPANS", None)
    if ring is None:
        return None
    trace = stretch.trace
    spans = [sp for sp in ring if sp.end_ns > trace.start and sp.start_ns < trace.end]
    return spans or None


def overlap_ns(a, b):
    """The length of the intersection of two sets of disjoint, sorted
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(stretch, names):
    """The device's idle time while the host was inside a program span of
    one of ``names``, in percent of the traced stretch: the spans clipped
    to the stretch and joined (nested and repeated ones count once), then
    intersected exactly with the idle gaps.  0 where none of ``names``
    occurred, None where the stretch holds no program span."""
    spans = program_spans(stretch)
    if spans is None:
        return None
    trace = stretch.trace
    if trace.window_s <= 0:
        return None
    covered = union((max(sp.start_ns, trace.start), min(sp.end_ns, trace.end)) for sp in spans if sp.name in names)
    idle = gaps(trace.busy, trace.start, trace.end)
    return 100.0 * overlap_ns(covered, idle) * 1e-9 / trace.window_s


def lane_bodies(stretch):
    """Lane-bodies replayed in the stretch: the sum of ``width * bodies``
    over its ``pgf.chunk`` spans, or None where it holds no program span."""
    spans = program_spans(stretch)
    if spans is None:
        return None
    return sum(sp.attrs["width"] * sp.attrs["bodies"] for sp in spans if sp.name == "pgf.chunk")
