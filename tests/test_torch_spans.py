"""The port's program spans (``pygradflow_torch.util.span``, ``SPANS``).

The solve drivers record a span at each layer boundary only while a
``torch.profiler`` records: ``pgf.prepare`` (with ``pgf.check_input``
inside, whose ``graphed`` says whether the start was a graph replay), one
``pgf.chunk`` and one ``pgf.wait`` per chunk, ``pgf.compact`` per tier
change of a compacting batch, and ``pgf.finish``.  Without a
profiler a span site returns one shared null context and records nothing;
with one, the answers are the same bits.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import profile

from pygradflow_torch import Params, Solver, SolverStatus, util
from pygradflow_torch.parallel import BatchedSolver

from .torch_parity import Rosenbrock

RING_TO_PROFILER_NS = 1_000_000


@pytest.fixture(autouse=True)
def empty_ring():
    util.SPANS.clear()
    yield
    util.SPANS.clear()


def _starts(lanes, seed=5):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (lanes, 2))


def _single(jit_chunk=64):
    solver = Solver(Rosenbrock(), Params(jit_chunk=jit_chunk), device="cpu")
    return lambda: solver.solve(np.zeros(2))


def _batched(lanes=8, **kwargs):
    solver = BatchedSolver(Rosenbrock(), Params(), device="cpu", **kwargs)
    x0 = _starts(lanes)
    return lambda: solver.solve(x0)


def _compacting():
    """A batch that shrinks through several tiers: 256 lanes, looked at
    every 4 iterations, down to 4 lanes."""
    return _batched(256, min_tier=4, harvest_chunk=4)


def _profiled(solve):
    with profile() as prof:
        result = solve()
    return result, prof


def _by_start():
    return sorted(util.SPANS, key=lambda sp: sp.start_ns)


@pytest.mark.parametrize("make", [_single, _batched], ids=["single", "batched"])
def test_no_profiler_no_spans(make, monkeypatch):
    """Without a profiler a solve records nothing and never enters the
    recording path; every span site gets the same null context."""

    def refuse(name, attrs):
        raise AssertionError(f"{name} recorded without a profiler")

    monkeypatch.setattr(util, "_recorded", refuse)
    make()()
    assert len(util.SPANS) == 0
    null = util.span("pgf.prepare")
    assert util.span("pgf.chunk", width=1, bodies=64) is null
    assert isinstance(null, contextlib.nullcontext)


@pytest.mark.parametrize("jit_chunk,chunks", [(64, 1), (8, 4)])
def test_single_solve_spans(jit_chunk, chunks):
    """``pgf.prepare`` holds ``pgf.check_input``; then a ``pgf.chunk`` of
    width 1 and ``jit_chunk`` bodies and a ``pgf.wait`` per chunk, then
    ``pgf.finish``: all of one call, the solve drivers' spans at the top."""
    solve = _single(jit_chunk)
    solve()
    result, _ = _profiled(solve)
    assert result.iterations == 30
    spans = _by_start()
    assert len({sp.call for sp in spans}) == 1
    top = [sp for sp in spans if sp.parent == -1]
    assert [sp.name for sp in top] == ["pgf.prepare"] + ["pgf.chunk", "pgf.wait"] * chunks + ["pgf.finish"]
    (check,) = [sp for sp in spans if sp.parent != -1]
    assert check.name == "pgf.check_input" and check.parent == top[0].index
    assert check.attrs == {"graphed": False}  # on the CPU the input check runs eagerly
    assert top[0].start_ns <= check.start_ns <= check.end_ns <= top[0].end_ns
    for sp in top:
        assert sp.start_ns <= sp.end_ns
        if sp.name == "pgf.chunk":
            assert sp.attrs == {"width": 1, "bodies": jit_chunk}
    for before, after in zip(top, top[1:]):
        assert before.end_ns <= after.start_ns


def test_calls_are_numbered():
    """Each solve call of either driver has its own call number."""
    single, batched = _single(), _batched()
    _profiled(lambda: (single(), batched(), single()))
    calls = [sp.call for sp in _by_start() if sp.name == "pgf.prepare"]
    assert len(calls) == 3 and calls[0] < calls[1] < calls[2]


def test_compacting_batch_records_each_tier_change():
    """One ``pgf.compact`` per tier change, with the widths before and
    after; every ``pgf.chunk`` runs at the tier then current; a last
    ``pgf.compact`` scatters back to the whole batch."""
    solve = _compacting()
    result, _ = _profiled(solve)
    assert bool((result.status == int(SolverStatus.Optimal)).all())
    spans = _by_start()
    assert len({sp.call for sp in spans}) == 1
    assert spans[0].name == "pgf.prepare" and spans[-1].name == "pgf.finish"
    width, tiers, waits = 256, [256], 0
    compacts = [sp for sp in spans if sp.name == "pgf.compact"]
    for sp in spans[1:-1]:
        if sp.name == "pgf.chunk":
            assert sp.attrs == {"width": width, "bodies": 4}
        elif sp.name == "pgf.wait":
            waits += 1
        elif sp is not compacts[-1]:
            assert sp.name == "pgf.compact" and sp.attrs["width"] == width and sp.attrs["new_width"] < width
            width = sp.attrs["new_width"]
            tiers.append(width)
    assert compacts[-1].attrs == {"width": width, "new_width": 256}
    assert len(compacts) - 1 == len(tiers) - 1 >= 2
    assert tiers == sorted(tiers, reverse=True) and all(a == 4 * b for a, b in zip(tiers, tiers[1:]))
    assert waits == sum(sp.name == "pgf.chunk" for sp in spans)


@pytest.mark.parametrize("make", [_single, _compacting], ids=["single", "compacting"])
def test_ring_agrees_with_the_profilers_copy(make):
    """Each span in the ring and its event in the profiler's trace agree
    within 1 ms at both ends."""
    solve = make()
    _profiled(solve)  # the profiler's first events of a process come late
    util.SPANS.clear()
    _, prof = _profiled(solve)
    events = sorted(
        (e.name(), e.start_ns(), e.end_ns())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("pgf.") and "CUDA" not in str(e.device_type())
    )
    ring = sorted((sp.name, sp.start_ns, sp.end_ns) for sp in util.SPANS)
    assert [e[0] for e in events] == [r[0] for r in ring]
    for (name, start, end), (_, ring_start, ring_end) in zip(events, ring):
        assert abs(start - ring_start) < RING_TO_PROFILER_NS, name
        assert abs(end - ring_end) < RING_TO_PROFILER_NS, name


def test_profiler_copy_is_an_operator_event():
    """A span's profiler copy is an operator event, not a user annotation,
    which the profiler would mirror onto the device's timeline."""
    _, prof = _profiled(_single())
    kinds = {e.activity_type() for e in prof.profiler.kineto_results.events() if e.name().startswith("pgf.")}
    assert kinds == {"cpu_op"}


def _answer(result):
    return [torch.as_tensor(getattr(result, f)) for f in ("x", "y", "d", "status", "iterations")]


@pytest.mark.parametrize("make", [_single, _compacting], ids=["single", "compacting"])
def test_profiler_leaves_the_answers_bit_for_bit(make):
    plain = _answer(make()())
    traced = _answer(_profiled(make())[0])
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


def test_profile_dir_trace_holds_every_span(tmp_path):
    """``Params.profile_dir`` traces the whole call: its Chrome trace names
    every span of a single solve."""
    Solver(Rosenbrock(), Params(profile_dir=str(tmp_path)), device="cpu").solve(np.zeros(2))
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pgf.prepare", "pgf.check_input", "pgf.chunk", "pgf.wait", "pgf.finish"} <= names
    assert len(util.SPANS) == 5
