"""The comparison fails what it must: the control (the program's own
float32 path) and, with the timed path broken underneath, each fault that
a cell can have.  Driven on the CPU at small sizes, past the harness's look
for a card; the cells run on one card, so no exchange between cards can
be left out.  Every lane and call poses an instance of its own, so an
answer given to the wrong lane or call is a wrong answer."""

import pytest
import torch

from harness.cell import run
from pygradflow_torch import Solver
from pygradflow_torch.parallel import BatchedSolver
from pygradflow_torch.parallel.batch import LaneLoop
from pygradflow_torch.solver import SolveLoop

CELLS = ["rosenbrock.sweep-b16384", "rosenbrock.single"]
BATCHED = {"rosenbrock.sweep-b16384"}


def _run(small, cell, overrides=None):
    return run(cell, 2**31 + 77, 0.3, False, "cpu", small, overrides=overrides)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(small, cell):
    result = _run(small, cell)
    assert result["correct"] and result["failed"] == 0
    assert result["checks"]["f32_grid_share"]["value"] == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(small, cell):
    result = _run(small, cell, {"precision": "Single"})
    assert not result["correct"]
    assert result["checks"]["f32_grid_share"]["value"] == 1.0


def _unchanged(self, state):
    """A step that returns its state unchanged (but counts the iteration)."""
    return state._replace(iteration=state.iteration + 1)


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged(small, cell, monkeypatch):
    monkeypatch.setattr(LaneLoop if cell in BATCHED else SolveLoop, "run_iteration", _unchanged)
    result = _run(small, cell, {"iteration_limit": 20})
    assert not result["correct"]
    assert result["checks"]["not_optimal"]["value"] == result["attempted"]


def _patch_batched(monkeypatch, fault):
    """``BatchedSolver.solve`` replaced by ``fault(solve, self, x0, data)``."""
    solve = BatchedSolver.solve

    def broken(self, x0, y0=None, data=None):
        return fault(solve, self, x0, data)

    monkeypatch.setattr(BatchedSolver, "solve", broken)


def _lanes(res, index):
    """The result with every per-lane field taken at ``index``."""
    return res._replace(**{k: getattr(res, k)[index] for k in ("x", "y", "status", "iterations", "total_res")})


@pytest.mark.parametrize("cell", sorted(BATCHED))
def test_half_of_the_batch_left_out(small, cell, monkeypatch):
    """Only the first half of the lanes is solved; the rest come back as
    they went in, claimed Optimal."""
    solve = BatchedSolver.solve

    def half(self, x0, y0=None, data=None):
        k = x0.shape[0] // 2
        res = solve(self, x0[:k], data=tuple(a[:k] for a in data))
        rest = x0[k:].to(res.x.dtype)
        return res._replace(
            x=torch.cat([res.x, rest]),
            y=torch.cat([res.y, torch.zeros((rest.shape[0],) + res.y.shape[1:], dtype=res.y.dtype)]),
            status=torch.cat([res.status, res.status[:1].expand(rest.shape[0])]),
            iterations=torch.cat([res.iterations, res.iterations[:1].expand(rest.shape[0])]),
            total_res=torch.cat([res.total_res, res.total_res[:1].expand(rest.shape[0])]),
        )

    monkeypatch.setattr(BatchedSolver, "solve", half)
    result = _run(small, cell)
    assert not result["correct"]
    assert result["checks"]["kkt_res_max"]["value"] > result["checks"]["kkt_res_max"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(small, cell, monkeypatch):
    """The first component of the first answer of each call moved by 1e-4."""
    if cell in BATCHED:
        solve = BatchedSolver.solve

        def altered(self, x0, y0=None, data=None):
            res = solve(self, x0, y0, data)
            x = res.x.clone()
            x[0, 0] += 1e-4
            return res._replace(x=x)

        monkeypatch.setattr(BatchedSolver, "solve", altered)
    else:
        solve = Solver.solve

        def altered(self, *args, **kwargs):
            res = solve(self, *args, **kwargs)
            res._x = res._x.clone()
            res._x[0] += 1e-4
            return res

        monkeypatch.setattr(Solver, "solve", altered)
    result = _run(small, cell)
    assert not result["correct"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("cell", sorted(BATCHED))
def test_half_solved_and_copied_into_the_other_half(small, cell, monkeypatch):
    """The first half of the lanes solved, its answers copied into the
    second half, all claimed Optimal."""

    def fault(solve, self, x0, data):
        k = x0.shape[0] // 2
        res = solve(self, x0[:k], data=tuple(a[:k] for a in data))
        return _lanes(res, torch.cat([torch.arange(k), torch.arange(x0.shape[0] - k)]))

    _patch_batched(monkeypatch, fault)
    result = _run(small, cell)
    assert not result["correct"]
    assert result["failed"] >= result["attempted"] // 3


@pytest.mark.parametrize("cell", sorted(BATCHED))
def test_lane_0s_answer_in_every_lane(small, cell, monkeypatch):
    def fault(solve, self, x0, data):
        return _lanes(solve(self, x0, data=data), torch.zeros(x0.shape[0], dtype=torch.long))

    _patch_batched(monkeypatch, fault)
    result = _run(small, cell)
    assert not result["correct"]
    assert result["failed"] >= result["attempted"] // 2


@pytest.mark.parametrize("cell", sorted(BATCHED))
def test_lanes_out_of_order(small, cell, monkeypatch):
    """Two neighbouring lanes swapped, as a wrong gather after compaction
    would leave them."""

    def fault(solve, self, x0, data):
        order = torch.arange(x0.shape[0])
        order[[0, 1]] = order[[1, 0]]
        return _lanes(solve(self, x0, data=data), order)

    _patch_batched(monkeypatch, fault)
    result = _run(small, cell)
    assert not result["correct"]
    assert result["failed"] >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_the_previous_calls_answer(small, cell, monkeypatch):
    """After its first call the solver returns the answer it gave before,
    without solving."""
    owner = BatchedSolver if cell in BATCHED else Solver
    solve = owner.solve
    cache = []

    def cached(self, *args, **kwargs):
        if not cache:
            cache.append(solve(self, *args, **kwargs))
        return cache[0]

    monkeypatch.setattr(owner, "solve", cached)
    result = _run(small, cell)
    assert not result["correct"]
    assert result["checks"]["kkt_res_max"]["value"] > 1.0
