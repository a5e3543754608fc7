"""The readers of the program's spans (``harness/spans.py`` and the
metrics on it), on synthetic traces and synthetic rings."""

from types import SimpleNamespace

import pytest
from conftest import BENCH, ROOT

from harness.manifest import Manifest
from harness.spans import overlap_ns
from harness.trace import STRETCH, Trace
from pygradflow_torch import util

MANIFEST = Manifest(ROOT, BENCH)
IDLE = ("idle_entry", "idle_check_input", "idle_launch", "idle_wait", "idle_compact")

# a stretch of 1000 ns, busy at 100-200, 400-500 and 700-750: idle at
# 0-100, 200-400, 500-700 and 750-1000
DEVICE = [
    ("user_annotation", STRETCH, 0, 1000),
    ("kernel", "a", 100, 200),
    ("kernel", "b", 400, 450),
    ("gpu_memcpy", "Memcpy DtoH", 450, 500),
    ("kernel", "c", 700, 750),
]


def _span(index, name, start, end, parent=-1, **attrs):
    return util.Span(index, name, start, end, 7, parent, attrs)


RING = [
    _span(1, "pgf.check_input", 20, 80, parent=0),
    _span(0, "pgf.prepare", -50, 150),  # begins before the stretch: clipped
    _span(2, "pgf.chunk", 150, 450, width=16, bodies=4),
    _span(3, "pgf.chunk", 300, 600, width=4, bodies=4),  # overlaps the last: counted once
    _span(4, "pgf.wait", 600, 900),
    _span(5, "pgf.finish", 900, 1100),  # ends after the stretch: clipped
    _span(6, "pgf.prepare", 2000, 2100),  # outside the stretch
]


@pytest.fixture
def ring(monkeypatch):
    spans = list(RING)
    monkeypatch.setattr(util, "SPANS", spans)
    return spans


def _ctx(events=DEVICE, iterations=0):
    return SimpleNamespace(stretch=SimpleNamespace(trace=Trace(list(events)), iterations=iterations, solves=4))


def _read(name, ctx):
    return MANIFEST.metric_reader(name).read(ctx)


def test_overlap_of_interval_sets():
    assert overlap_ns([[0, 10], [20, 30]], [(5, 25)]) == 10
    assert overlap_ns([[0, 10]], [(10, 20)]) == 0
    assert overlap_ns([], [(0, 5)]) == 0


def test_idle_is_intersected_exactly_with_the_spans(ring):
    ctx = _ctx()
    # prepare clipped to 0-150 (idle 0-100) and finish to 900-1000 (idle 900-1000)
    assert _read("idle_entry", ctx) == pytest.approx(20.0)
    # the nested check 20-80 lies in idle
    assert _read("idle_check_input", ctx) == pytest.approx(6.0)
    # the two chunks join into 150-600: idle 200-400 and 500-600
    assert _read("idle_launch", ctx) == pytest.approx(30.0)
    # 600-900: idle 600-700 and 750-900
    assert _read("idle_wait", ctx) == pytest.approx(25.0)
    assert _read("idle_compact", ctx) == 0.0  # no compaction in the stretch
    disjoint = sum(_read(n, ctx) for n in IDLE if n != "idle_check_input")
    assert disjoint <= _read("idle_share", ctx) + 1e-9


def test_a_gap_across_several_spans_is_split_between_them(ring):
    ring[:] = [_span(0, "pgf.chunk", 0, 250, width=1, bodies=1), _span(1, "pgf.wait", 250, 1000)]
    ctx = _ctx([e for e in DEVICE if e[1] != "b" and e[0] != "gpu_memcpy"])  # one gap, 200-700
    assert _read("idle_launch", ctx) == pytest.approx(15.0)  # 0-100 and 200-250
    assert _read("idle_wait", ctx) == pytest.approx(70.0)  # 250-700 and 750-1000


def test_no_program_span_reads_none(ring, monkeypatch):
    ring[:] = [sp for sp in RING if sp.start_ns >= 1000]
    for name in IDLE + ("lane_use",):
        assert _read(name, _ctx()) is None
    assert _read("idle_wait", SimpleNamespace(stretch=None)) is None
    monkeypatch.delattr(util, "SPANS")  # a program that records no spans
    for name in IDLE + ("lane_use",):
        assert _read(name, _ctx()) is None


def test_lane_use(ring):
    # 16 * 4 + 4 * 4 = 80 lane-bodies replayed, 60 of them advanced a lane
    assert _read("lane_use", _ctx(iterations=60)) == pytest.approx(75.0)
    ring[:] = [sp for sp in RING if sp.name != "pgf.chunk"]
    assert _read("lane_use", _ctx(iterations=60)) is None


def test_capture_s_reads_the_counter(monkeypatch):
    from collections import Counter

    monkeypatch.setattr(util, "CAPTURES", Counter(graphs=5, ns=2_500_000_000))
    assert _read("capture_s", SimpleNamespace()) == pytest.approx(2.5)
    monkeypatch.delattr(util, "CAPTURES")
    assert _read("capture_s", SimpleNamespace()) is None


def test_program_spans_are_no_device_work():
    """The spans' host events, as operator events or as user annotations,
    and the annotations' mirrors on the device's timeline leave busy time,
    idle share and the kernel count as they were."""
    mirrors = [(kind, sp.name, sp.start_ns, sp.end_ns)
               for sp in RING for kind in ("cpu_op", "user_annotation", "gpu_user_annotation")]
    plain, traced = _ctx(), _ctx(DEVICE + mirrors)
    assert traced.stretch.trace.busy_s == plain.stretch.trace.busy_s
    assert len(traced.stretch.trace.kernels) == len(plain.stretch.trace.kernels) == 3
    for name in ("idle_share", "kernels_per_solve"):
        assert _read(name, traced) == _read(name, plain)
    assert traced.stretch.trace.idle_gaps() == plain.stretch.trace.idle_gaps()


def test_new_metrics_name_their_cells():
    layers = {m["name"]: m for m in MANIFEST.data["per_layer"]}
    sweep, single = "rosenbrock.sweep-b16384", "rosenbrock.single"
    cells = {"idle_entry": [sweep, single], "idle_check_input": [single], "idle_launch": [sweep, single],
             "idle_wait": [sweep, single], "idle_compact": [sweep], "lane_use": [sweep],
             "capture_s": [sweep, single]}
    for name, want in cells.items():
        assert layers[name]["workloads"] == want
        assert layers[name]["source"] == ("program_counter" if name == "capture_s" else "program_span")
