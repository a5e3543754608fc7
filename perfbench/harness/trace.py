"""Reduction of a ``torch.profiler`` trace, read in memory.

The traced stretch of a run is one host span named ``STRETCH``; inside it
the harness's own spans ``draw``, ``solve``, ``sync`` and ``check`` say what
the host was doing.  The device is busy where a kernel, a copy or a set ran
(their intervals joined, so overlaps count once), idle elsewhere in the
stretch, and each idle gap is put down to the host span around its middle.
The profiler mirrors each host span on the device's timeline, under the
span's name and, in some versions of torch, as a kernel: those are no
device work and are left out.
"""

from collections import Counter, defaultdict

STRETCH = "stretch"
HOST_SPANS = ("draw", "solve", "sync", "check")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160


def _kind(event):
    """Kineto's activity type of ``event``; from the device type and the
    name where this torch lacks ``activity_type``."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    if "CUDA" not in str(event.device_type()):
        return "user_annotation" if event.is_user_annotation() else "cpu_op"
    name = event.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def union(intervals):
    """Disjoint, sorted intervals covering the same points as
    ``intervals`` (pairs of start and end)."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def gaps(busy, start, end):
    """The idle intervals of [start, end] between the disjoint sorted
    ``busy`` intervals."""
    out, cursor = [], start
    for s, e in busy:
        if s > cursor:
            out.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        out.append((cursor, end))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """The events of one profiled stretch: ``events`` are
    (kind, name, start_ns, end_ns) tuples; ``from_profile`` takes them from
    a finished ``torch.profiler.profile``."""

    def __init__(self, events):
        windows = [(s, e) for kind, name, s, e in events if kind == "user_annotation" and name == STRETCH]
        if len(windows) != 1:
            raise ValueError(f"expected one {STRETCH!r} span, found {len(windows)}")
        self.start, self.end = windows[0]
        clip = []
        self.kernels = []
        self.kinds = Counter(kind for kind, *_ in events)
        for kind, name, s, e in events:
            if kind in DEVICE_KINDS and name not in HOST_SPANS and name != STRETCH:
                s, e = max(s, self.start), min(e, self.end)
                if e > s:
                    clip.append((s, e))
                    if kind == "kernel":
                        self.kernels.append((name, e - s))
        self.busy = union(clip)
        self.spans = [(name, s, e) for kind, name, s, e in events
                      if kind == "user_annotation" and name in HOST_SPANS]

    @classmethod
    def from_profile(cls, prof):
        events = [(_kind(e), e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]
        return cls(events)

    @property
    def window_s(self):
        return (self.end - self.start) * 1e-9

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy) * 1e-9

    def device_ops(self, top=10):
        """The kernels that took most device time, summed by name:
        ``[[name, seconds], ...]``."""
        total = defaultdict(int)
        for name, ns in self.kernels:
            total[name[:NAME_CHARS]] += ns
        return [[n, t * 1e-9] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """Idle device time summed by the host span around each gap's
        middle (``"none"`` where the harness had no span open):
        ``[[span, seconds], ...]``."""
        spans = sorted(self.spans, key=lambda sp: sp[1])
        total = defaultdict(int)
        for s, e in gaps(self.busy, self.start, self.end):
            mid = (s + e) // 2
            inside = [name for name, a, b in spans if a <= mid <= b]
            total[inside[-1] if inside else "none"] += e - s
        return [[n, t * 1e-9] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
