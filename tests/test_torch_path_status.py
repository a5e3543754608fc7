"""``collect_path`` and the terminal statuses of the port against the JAX
package: the recorded path of HS71 with its model times, its truncation
at ``path_capacity``, ``BatchedSolver``'s refusal of it, and the statuses
that the option tests do not reach (Unbounded and both LocallyInfeasible
problems of ``tests/test_conds.py``, TimeLimit and IterationLimit of
``tests/test_solver.py``), each in the single and the batched loop against
a live JAX run."""

import logging

import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch import Problem
from pygradflow_torch.parallel import BatchedSolver
from pygradflow_tpu.parallel import BatchedSolver as JBatchedSolver

from .test_torch_batch import _check_lanes
from .torch_parity import Rosenbrock, assert_same_solve, numpy, params_pair, solve_both, tensor

HS71_X0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])


def _hs71():
    from tests.problems import HS71 as JHS71

    from .torch_parity import HS71

    return JHS71(), HS71()


def test_collect_path_matches_jax():
    """HS71 (19/13): 14 columns, x and y within 1e-10.  Each model time adds
    1/lambda, and the last lambda (near 1e-3) carries the roundings of the
    PI controller's exp and log, which differ between numpy and XLA: the
    times are held to 1e-7 relative (the last of 14 differs by 2e-8)."""
    jprob, tprob = _hs71()
    jr, tr = solve_both(jprob, tprob, HS71_X0, np.zeros(2), collect_path=True)
    assert_same_solve(tr, jr)
    assert tr.path.shape == (7, tr.num_accepted_steps + 1) == jr.path.shape
    np.testing.assert_allclose(numpy(tr.path), jr.path, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(numpy(tr.model_times), jr.model_times, rtol=1e-7, atol=0)
    np.testing.assert_allclose(numpy(tr.model_times[:-1]), jr.model_times[:-1], rtol=1e-10, atol=0)
    np.testing.assert_allclose(numpy(tr.primal_path), jr.primal_path, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(numpy(tr.dual_path), jr.dual_path, rtol=1e-10, atol=1e-10)
    for speed in ("model_speed", "primal_model_speed", "dual_model_speed"):
        np.testing.assert_allclose(numpy(getattr(tr, speed)), getattr(jr, speed), rtol=1e-7)
    np.testing.assert_array_equal(numpy(tr.path[:, 0]), np.concatenate([HS71_X0, np.zeros(2)]))
    assert tr.model_times[0] == 0.0 and bool((torch.diff(tr.model_times) > 0).all())


def test_collect_path_truncates_with_warning(caplog):
    """``path_capacity=5``: the ring keeps the first 5 columns and the
    solve warns, as the JAX package does."""
    jprob, tprob = _hs71()
    _, tp = params_pair(collect_path=True, path_capacity=5)
    jp, _ = params_pair(collect_path=True, path_capacity=5)
    with caplog.at_level(logging.WARNING):
        tr = pygradflow_torch.Solver(tprob, tp, device="cpu").solve(tensor(HS71_X0), tensor(np.zeros(2)))
    assert "Trajectory truncated: 13 accepted steps exceed path_capacity=5" in caplog.text
    jr = pygradflow_tpu.Solver(jprob, jp).solve(HS71_X0, np.zeros(2))
    assert tr.path.shape == (7, 5) == jr.path.shape
    np.testing.assert_allclose(numpy(tr.path), jr.path, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(numpy(tr.model_times), jr.model_times, rtol=1e-10, atol=0)


def test_collect_path_off_has_no_path():
    _, tprob = _hs71()
    r = pygradflow_torch.Solver(tprob, pygradflow_torch.Params(), device="cpu").solve(tensor(HS71_X0), tensor(np.zeros(2)))
    assert r.path is None and r.model_speed is None


def test_batched_collect_path_raises():
    """JAX asserts; the port raises ``ValueError``."""
    with pytest.raises(ValueError, match="collect_path"):
        BatchedSolver(Rosenbrock(), pygradflow_torch.Params(collect_path=True), device="cpu")


class UnboundedProblem(Problem):
    """Twin of ``tests/test_conds.py::UnboundedProblem``."""

    def __init__(self):
        super().__init__(np.array([-np.inf]), np.array([np.inf]))

    def obj(self, x):
        return x[0]


class InfeasibleBounds(Problem):
    """Twin of ``tests/test_conds.py::InfeasibleBounds``."""

    def __init__(self):
        super().__init__(np.zeros(2), np.full(2, np.inf), num_cons=1)

    def obj(self, x):
        return torch.dot(x, x)

    def cons(self, x):
        return (x[0] + x[1] + 1.0)[None]


class InfeasibleNonlinear(Problem):
    """Twin of ``tests/test_conds.py::InfeasibleNonlinear``."""

    def __init__(self):
        super().__init__(np.array([-np.inf]), np.array([np.inf]), num_cons=1)

    def obj(self, x):
        return x[0] ** 2

    def cons(self, x):
        return (x[0] ** 2 + 1.0)[None]


def _cond_pair(name):
    import tests.test_conds as jconds

    return getattr(jconds, name)(), globals()[name]()


STATUS_CASES = {
    "Unbounded": ("UnboundedProblem", [[0.0], [1.0]], {}, (34, 34)),
    "LocallyInfeasible_bounds": ("InfeasibleBounds", [[1.0, 1.0], [2.0, 0.5]], {}, (1, 1)),
    "LocallyInfeasible_nonlinear": ("InfeasibleNonlinear", [[0.5], [-1.5]], {}, (68, 46)),
    "IterationLimit": ("Rosenbrock", [[0.0, 0.0], [-1.2, 1.0], [1.0, 1.0]], dict(iteration_limit=20), (20, 15)),
    "TimeLimit": ("Rosenbrock", [[0.0, 0.0], [-1.2, 1.0]], dict(time_limit=0.0, jit_chunk=1), (1, 0)),
}


@pytest.mark.parametrize("case", list(STATUS_CASES))
def test_status_matches_jax(case):
    """The single solve from the first start point, then the batch of all
    of them: statuses, counts and solutions equal to the JAX runs.  The
    nonlinear infeasible problem drives x to 1e-9 and y to 1e13, held to
    1e-6 relative or 1e-8 absolute."""
    name, x0s, kwargs, counts = STATUS_CASES[case]
    status = case.split("_")[0]
    if name == "Rosenbrock":
        from tests.problems import Rosenbrock as JRosenbrock

        jprob, tprob = JRosenbrock(), Rosenbrock()
    else:
        jprob, tprob = _cond_pair(name)
    x0s = np.asarray(x0s)
    jr, tr = solve_both(jprob, tprob, x0s[0], **kwargs)
    assert (jr.status.name, jr.iterations, jr.num_accepted_steps) == (status,) + counts
    if name == "InfeasibleNonlinear":
        assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == (status,) + counts
        for ours, ref in ((tr.x, jr.x), (tr.y, jr.y), (tr.d, jr.d)):
            np.testing.assert_allclose(numpy(ours), ref, rtol=1e-6, atol=1e-8)
    else:
        assert_same_solve(tr, jr)

    jp, tp = params_pair(**kwargs)
    jb = JBatchedSolver(jprob, jp).solve(x0s)
    tb = BatchedSolver(tprob, tp, device="cpu").solve(x0s)
    if name == "InfeasibleNonlinear":
        np.testing.assert_array_equal(numpy(tb.status), jb.status)
        np.testing.assert_array_equal(numpy(tb.iterations), jb.iterations)
        np.testing.assert_array_equal(numpy(tb.accepted_steps), jb.accepted_steps)
        np.testing.assert_allclose(numpy(tb.x), jb.x, rtol=1e-6, atol=1e-8)
    else:
        _check_lanes(tb, jb)
    assert pygradflow_torch.SolverStatus(int(tb.status[0])).name == status
