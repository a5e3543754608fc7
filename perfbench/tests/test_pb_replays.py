"""``replays_per_call``: the bodies of the traced stretch's ``pgf.chunk``
spans over its calls, on synthetic traces and rings."""

from types import SimpleNamespace

import pytest
from conftest import BENCH, ROOT

from harness.manifest import Manifest
from harness.trace import STRETCH, Trace
from pygradflow_torch import util

MANIFEST = Manifest(ROOT, BENCH)
DEVICE = [("user_annotation", STRETCH, 0, 1000), ("kernel", "a", 100, 200)]


def _span(index, name, start, end, **attrs):
    return util.Span(index, name, start, end, 3, -1, attrs)


def _ctx(calls):
    return SimpleNamespace(stretch=SimpleNamespace(trace=Trace(list(DEVICE)), calls=calls))


def _read(ctx):
    return MANIFEST.metric_reader("replays_per_call").read(ctx)


def test_bodies_over_calls(monkeypatch):
    monkeypatch.setattr(util, "SPANS", [
        _span(0, "pgf.prepare", 0, 50),
        _span(1, "pgf.chunk", 50, 300, width=1, bodies=32),
        _span(2, "pgf.wait", 300, 400),
        _span(3, "pgf.chunk", 400, 600, width=1, bodies=64),  # a second call's two chunks
        _span(4, "pgf.chunk", 600, 900, width=1, bodies=3),
        _span(5, "pgf.chunk", 2000, 2100, width=1, bodies=64),  # outside the stretch
    ])
    assert _read(_ctx(slice(4, 6))) == pytest.approx(99 / 2)
    assert _read(_ctx(slice(4, 4))) is None


def test_no_program_span_reads_none(monkeypatch):
    monkeypatch.setattr(util, "SPANS", [_span(0, "pgf.chunk", 2000, 2100, width=1, bodies=64)])
    assert _read(_ctx(slice(0, 1))) is None
    assert _read(SimpleNamespace(stretch=None)) is None
    monkeypatch.delattr(util, "SPANS")  # a program that records no spans
    assert _read(_ctx(slice(0, 1))) is None


def test_entry_names_its_cells():
    (entry,) = [m for m in MANIFEST.data["per_layer"] if m["name"] == "replays_per_call"]
    assert entry == {"name": "replays_per_call", "unit": "bodies/call", "better": "lower",
                     "source": "program_span", "layer": "driver", "moves": "solves_per_s",
                     "workloads": ["rosenbrock.sweep-b16384", "rosenbrock.single"]}
