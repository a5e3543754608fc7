"""A single solve's start (``SolveLoop.start``) on the CPU: the start
iterate and the input check's verdicts as one function of pure tensor
code, the one that the card captures as a CUDA graph
(``SolveLoop.graphed_start``).  Run eagerly here, it gives
``evaluate_iterate``'s iterate bit for bit and a false verdict where
``validate_fns`` raises or warns.  ``Solver._start``'s graphed branch,
driven here with the start run eagerly in place of the replay, raises
``validate_fns``'s own error through the eager fallback and logs its
warning once."""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from pygradflow_torch import Params, Solver, util
from pygradflow_torch.eval import EvalError, validate_fns
from pygradflow_torch.iterate import evaluate_iterate
from pygradflow_torch.solver import START_FLAGS

from . import cops_chain as cc
from .torch_parity import HS71, Rosenbrock

HS71_START = (np.array([1.0, 5.0, 5.0, 1.0, 0.0]), np.zeros(2))

BROKEN = {
    "objective": ("Infinite objective", {"objective"}),
    "gradient": ("Non-finite gradient", {"gradient"}),
    "constraints": ("Non-finite constraints", {"constraints"}),
    "jacobian": ("Non-finite Jacobian", {"jacobian"}),
    # NaN is close to nothing, itself included
    "hessian": ("Non-finite Hessian", {"hessian", "symmetric"}),
}


class Faulty(HS71):
    """HS71 with one evaluation made NaN in every entry (``broken``) or
    its Hessian made asymmetric (``"asymmetric"``); each derivative comes
    from its own method, so the others stay finite."""

    def __init__(self, broken):
        super().__init__()
        self.broken = broken

    def _spoil(self, part, value):
        return value + torch.nan if part == self.broken else value

    def obj(self, x):
        return self._spoil("objective", super().obj(x))

    def obj_grad(self, x, *args):
        return self._spoil("gradient", super().obj_grad(x, *args))

    def cons(self, x):
        return self._spoil("constraints", super().cons(x))

    def cons_jac(self, x, *args):
        return self._spoil("jacobian", super().cons_jac(x, *args))

    def lag_hess(self, x, y, *args):
        hess = self._spoil("hessian", super().lag_hess(x, y, *args))
        if self.broken == "asymmetric":
            hess = hess + torch.triu(torch.ones_like(hess), diagonal=1)
        return hess


class LongGradient(HS71):
    """HS71 whose gradient has one entry too many."""

    def obj_grad(self, x, *args):
        return torch.cat([super().obj_grad(x, *args), x[:1]])


def _start_point(solver, x0, y0=None):
    return solver.transform.create_transformed_initial(x0, y0, solver.device)


def _graphed_on_cpu(solver, monkeypatch):
    """``solver`` on the graphed route: ``Solver._start``'s graphed branch,
    the start run eagerly where the card replays its graph, and each
    chunk's bodies run eagerly where the card replays them (the chunk's
    read is the graphed route's)."""
    loop = solver._loop

    def start(x, y):
        util.STARTS["graphed"] += 1
        return loop.start(x, y)

    monkeypatch.setattr(loop, "use_graphs", True)
    monkeypatch.setattr(loop, "graphed", True)  # for a bare _start; a solve decides it again
    monkeypatch.setattr(loop, "graphed_start", start)
    monkeypatch.setattr(loop.graph, "run", loop.eager_chunk)
    return solver


def _expected(false):
    return [name not in false for name in START_FLAGS]


def _validate_error(solver, x, y):
    with pytest.raises(EvalError) as err:
        validate_fns(solver.transform.fns, x, y)
    return str(err.value)


@pytest.mark.parametrize("part", list(BROKEN))
def test_non_finite_start_gives_its_verdict_and_validate_fns_error(part, monkeypatch):
    """Each non-finite evaluation reads false in its own verdict; on the
    graphed branch that verdict runs the eager check, which raises what
    ``validate_fns`` raises, wrapped as the solve always wrapped it."""
    message, false = BROKEN[part]
    solver = Solver(Faulty(part), Params(), device="cpu")
    x, y = _start_point(solver, *HS71_START)
    start = solver._loop.start(x, y)
    assert start.shaped
    assert start.flags.dtype == torch.bool and start.flags.tolist() == _expected(false)
    assert _validate_error(solver, x, y) == message

    _graphed_on_cpu(solver, monkeypatch)
    counts, reads = dict(util.STARTS), util.HOST_READS["start"]
    with pytest.raises(Exception, match="Failed to evaluate initial iterate") as err:
        solver.solve(*HS71_START)
    assert isinstance(err.value.__cause__, EvalError) and str(err.value.__cause__) == message
    assert util.STARTS["graphed"] - counts.get("graphed", 0) == 1
    assert util.STARTS["fallback"] - counts.get("fallback", 0) == 1
    assert util.HOST_READS["start"] - reads == 1


def test_non_finite_jacobian_is_checked_in_matrix_free_mode():
    """In matrix-free mode the iterate holds no Jacobian: the start
    evaluates it for the check alone, and its verdict still reads false."""
    solver = Solver(Faulty("jacobian"), Params(), device="cpu")
    loop = solver._loop
    loop.fns = loop.fns._replace(matrix_free=True)  # as make_fns gives it under Params.matrix_free
    x, y = _start_point(solver, *HS71_START)
    start = loop.start(x, y)
    assert tuple(start.it.cons_jac.shape) == (0, 5)
    assert start.shaped and start.flags.tolist() == _expected({"jacobian"})


def test_wrong_shape_sends_the_start_to_the_eager_check(monkeypatch):
    """A gradient of the wrong shape is seen where the start is captured
    (``shaped`` false); the eager check then names the shape."""
    solver = _graphed_on_cpu(Solver(LongGradient(), Params(), device="cpu"), monkeypatch)
    x, y = _start_point(solver, *HS71_START)
    assert not solver._loop.start(x, y).shaped
    fallback = util.STARTS["fallback"]
    with pytest.raises(Exception, match="Failed to evaluate initial iterate") as err:
        solver.solve(*HS71_START)
    assert str(err.value.__cause__) == "Invalid shape of gradient"
    assert util.STARTS["fallback"] - fallback == 1


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_asymmetric_hessian_warns_once(graphed, monkeypatch, caplog):
    """An asymmetric Hessian reads false in the symmetry verdict alone,
    and the start logs ``validate_fns``'s warning once on either branch,
    without the fallback."""
    solver = Solver(Faulty("asymmetric"), Params(), device="cpu")
    x, y = _start_point(solver, *HS71_START)
    assert solver._loop.start(x, y).flags.tolist() == _expected({"symmetric"})
    if graphed:
        _graphed_on_cpu(solver, monkeypatch)
    fallback = util.STARTS["fallback"]
    with caplog.at_level(logging.WARNING, logger="gradflow_torch"):
        it = solver._start(x, y)
    warned = [r for r in caplog.records if r.getMessage() == "Hessian not numerically symmetric"]
    assert len(warned) == 1
    assert (it is not None) == graphed and util.STARTS["fallback"] == fallback


def _cases():
    chain = cc.problem(16)
    delta, x0 = cc.instances(chain, 7, 1)[0]
    chain.example_data[0].copy_(torch.as_tensor(delta))
    return {
        "rosenbrock": (Rosenbrock(), Params(), (np.array([0.0, 0.0]),)),
        "hs71": (HS71(), Params(), HS71_START),
        "cops-chain-nh16": (chain, cc.params(), (x0,)),
    }


@pytest.mark.parametrize("case", ["rosenbrock", "hs71", "cops-chain-nh16"])
def test_start_iterate_is_evaluate_iterates(case):
    """The start's iterate is ``evaluate_iterate``'s, bit for bit, and a
    sound start reads true in every verdict; without ``validate_input`` the
    start holds the iterate alone."""
    problem, params, start_point = _cases()[case]
    for validate in (True, False):
        solver = Solver(problem, dataclasses.replace(params, validate_input=validate), device="cpu")
        x, y = _start_point(solver, *start_point)
        start = solver._loop.start(x, y)
        ref = evaluate_iterate(solver.transform.fns, x, y)
        for field in ref._fields:
            assert torch.equal(getattr(start.it, field), getattr(ref, field)), field
        if validate:
            assert start.shaped and start.flags.tolist() == [True] * len(START_FLAGS)
        else:
            assert start.flags is None


@pytest.mark.parametrize("case", ["rosenbrock", "hs71", "cops-chain-nh16"])
@pytest.mark.parametrize("validate", [True, False], ids=["checked", "unchecked"])
def test_graphed_start_branch_solves_as_the_eager_one(case, validate, monkeypatch):
    """A solve whose start takes the graphed branch (one verdict read under
    ``validate_input``, none without) ends as the eager solve does, bit for
    bit, with the same evaluation counts."""
    problem, params, start_point = _cases()[case]
    params = dataclasses.replace(params, validate_input=validate)
    counts = dict(util.STARTS)
    ref = Solver(problem, params, device="cpu").solve(*start_point)
    assert util.STARTS["eager"] - counts.get("eager", 0) == 1
    solver = _graphed_on_cpu(Solver(problem, params, device="cpu"), monkeypatch)
    reads = util.HOST_READS["start"]
    res = solver.solve(*start_point)
    assert util.HOST_READS["start"] - reads == int(validate)
    assert util.STARTS["graphed"] - counts.get("graphed", 0) == 1
    assert (res.status, res.iterations, res.num_accepted_steps) == (ref.status, ref.iterations,
                                                                     ref.num_accepted_steps)
    assert res.num_evals == ref.num_evals
    for field in ("x", "y", "d"):
        assert torch.equal(getattr(res, field), getattr(ref, field)), field
