"""The plain references agree with the port's own optimality measure on
the CPU at small sizes, at answers and at points on the way to them."""

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT

from harness.manifest import Manifest
from pygradflow_torch import Params, Solver
from pygradflow_torch.parallel import BatchedSolver

MANIFEST = Manifest(ROOT, BENCH)
TOL = 1e-8  # Params().active_tol


def _close(ours, theirs):
    np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-13)


def _rosenbrock():
    numbers = MANIFEST.config_numbers("rosenbrock")
    return numbers, MANIFEST.config_module("rosenbrock").make_problem(numbers, {}, "cpu", torch.float64)


@pytest.mark.parametrize("limit", [2, 10_000])
def test_rosenbrock_lanes(limit):
    numbers, problem = _rosenbrock()
    rng = np.random.default_rng(1)
    shift = rng.uniform(-1.0, 1.0, size=(8, 2))
    x0 = shift + rng.uniform(-1.5, 1.5, size=(8, 2))
    res = BatchedSolver(problem, Params(iteration_limit=limit), device="cpu").solve(x0, data=(shift,))
    ref = MANIFEST.reference("rosenbrock").residuals(res.x.numpy(), res.y.numpy(), {"shift": shift}, numbers, {}, TOL)
    _close(np.maximum(ref["stat"], ref["cons"]), res.total_res.numpy())
    if limit > 2:
        assert res.success.all()
        np.testing.assert_allclose(res.x.numpy(), np.stack([1 + shift[:, 0], 1 + shift[:, 1]], axis=1), atol=1e-5)


def test_rosenbrock_single_takes_its_instance_in_place():
    """A single solver poses the next instance by the data tensor that the
    problem holds, overwritten in place, as the harness does."""
    numbers, problem = _rosenbrock()
    solver = Solver(problem, Params(), device="cpu")
    for shift in ([0.0, 0.0], [0.5, -0.25], [-0.75, 0.5]):
        shift = torch.tensor(shift, dtype=torch.float64)
        problem.example_data[0].copy_(shift)
        res = solver.solve(shift.numpy())  # the documented start (0, 0), moved with the instance
        assert res.iterations == 30 and res.num_accepted_steps == 25  # the documented example's counts
        ref = MANIFEST.reference("rosenbrock").residuals(res.x[None].numpy(), res.y[None].numpy(),
                                                         {"shift": shift[None].numpy()}, numbers, {}, TOL)
        _close(ref["stat"][0], res.final_stat_res)
        np.testing.assert_allclose(res.x.numpy(), 1.0 + shift.numpy(), atol=1e-6)


def test_a_wrong_instance_reads_far_off():
    """The answer to one lane's instance, judged against another's."""
    numbers, problem = _rosenbrock()
    shift = np.array([[0.0, 0.0], [0.3, -0.2]])
    res = BatchedSolver(problem, Params(), device="cpu").solve(shift + 0.1, data=(shift,))
    ref = MANIFEST.reference("rosenbrock").residuals
    swapped = ref(res.x.numpy()[::-1], res.y.numpy(), {"shift": shift}, numbers, {}, TOL)
    assert (swapped["stat"] > 1.0).all()


def test_bound_multipliers_and_violation():
    """An answer on the upper control bound: the gradient's push outward is
    the bound's multiplier and leaves no stationarity residual; a step
    outside the box is a bound violation."""
    from reference.kkt import kkt_residuals

    x = np.array([[0.0, 2.5, -2.5, 3.0]])
    lb, ub = np.array([-np.inf, -2.5, -2.5, -2.5]), np.array([np.inf, 2.5, 2.5, 2.5])
    grad = np.array([[0.0, -1.0, 1.0, 0.0]])
    res = kkt_residuals(grad, np.zeros_like(grad), np.zeros((1, 0)), x, lb, ub, TOL)
    assert res["stat"][0] == 0.0 and res["cons"][0] == 0.0 and res["bound"][0] == 0.5
    grad = np.array([[0.0, 1.0, 0.0, 0.0]])  # pulls inward at the upper bound: a residual
    assert kkt_residuals(grad, np.zeros_like(grad), np.zeros((1, 0)), x, lb, ub, TOL)["stat"][0] == 1.0


def test_a_non_finite_answer_reads_inf():
    numbers = MANIFEST.config_numbers("rosenbrock")
    ref = MANIFEST.reference("rosenbrock").residuals(np.array([[np.nan, 1.0]]), np.zeros((1, 0)),
                                                     {"shift": np.zeros((1, 2))}, numbers, {}, TOL)
    assert ref["stat"][0] == np.inf


def test_references_import_nothing_of_the_program():
    import ast
    import os

    for f in os.listdir(MANIFEST.path("reference")):
        if f.endswith(".py"):
            tree = ast.parse(open(MANIFEST.path("reference", f)).read())
            names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
            names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
            assert {n.split(".")[0] for n in names} <= {"numpy", "reference", "math", "torch"}, f
