"""The port's ``Solver`` against the JAX package on the pendulum swing-up
with the mixed-precision LDL^T tier, plus the probes of the verify recipe.

N = 8, 16 and 128 factor through the right-looking kernel's plain version
(KKT 44, 84, 644); N = 256 through the left-looking one (KKT 1284), the
slice's full size.  Status, iteration and accepted-step counts must be
equal, x and y equal to 1e-6.
"""

import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch.runners.control import PendulumControl as TPendulum
from pygradflow_tpu.runners.control import PendulumControl as JPendulum

from .torch_parity import ANCHOR, numpy, params_pair, tensor

SOL_TOL = 1e-6


def _solve_both(N, x0=None, **kwargs):
    jp, tp = params_pair(**kwargs)
    jprob, tprob = JPendulum(N=N), TPendulum(N=N)
    jr = pygradflow_tpu.Solver(jprob, jp).solve(x0)
    tr = pygradflow_torch.Solver(tprob, tp, device="cpu").solve(None if x0 is None else tensor(x0))
    return jr, tr


@pytest.mark.parametrize(
    "N,counts", [(8, (15, 10)), (16, (30, 15)), (128, (17, 16)), (256, (18, 17))]
)
def test_pendulum_matches_jax(N, counts):
    x0 = JPendulum(N=N).x0_trajectory()
    jr, tr = _solve_both(N, x0, **ANCHOR)
    assert jr.status == pygradflow_tpu.SolverStatus.Optimal
    assert tr.status.name == jr.status.name
    assert (jr.iterations, jr.num_accepted_steps) == counts
    assert (tr.iterations, tr.num_accepted_steps) == counts
    np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=SOL_TOL)
    np.testing.assert_allclose(numpy(tr.y), jr.y, rtol=0, atol=SOL_TOL)
    np.testing.assert_allclose(numpy(tr.d), jr.d, rtol=0, atol=SOL_TOL)
    assert {c.name(): n for c, n in tr.num_evals.items()} == {
        c.name(): n for c, n in jr.num_evals.items()
    }
    assert tr.dist_factor == pytest.approx(jr.dist_factor, rel=1e-6)


def test_iteration_limit_probe():
    x0 = JPendulum(N=8).x0_trajectory()
    jr, tr = _solve_both(8, x0, **dict(ANCHOR, iteration_limit=3))
    for r in (jr, tr):
        assert r.status.name == "IterationLimit"
        assert r.iterations == 3


def test_default_initial_point():
    """No x0: 0 clipped into the bounds, as in the JAX package."""
    jr, tr = _solve_both(8, None, **ANCHOR)
    assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == (
        jr.status.name, jr.iterations, jr.num_accepted_steps,
    )
    np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=SOL_TOL)


def test_nan_initial_point_probe():
    x0 = JPendulum(N=8).x0_trajectory()
    x0[3] = np.nan
    jp, tp = params_pair(linear_solver_type="PallasLDLT")
    with pytest.raises(Exception, match="Failed to evaluate initial iterate"):
        pygradflow_tpu.Solver(JPendulum(N=8), jp).solve(x0)
    with pytest.raises(Exception, match="Failed to evaluate initial iterate"):
        pygradflow_torch.Solver(TPendulum(N=8), tp, device="cpu").solve(tensor(x0))


def test_lambda_limit_probe():
    """A lambda past ``lamb_max`` ends the solve with the reference's
    exception (``lamb_max`` below every lambda the first step can give)."""
    x0 = JPendulum(N=4).x0_trajectory()
    jp, tp = params_pair(**dict(ANCHOR, lamb_max=1e-3))
    with pytest.raises(Exception, match=r"exceeded maximum 0.001 \(incorrect derivatives\?\)"):
        pygradflow_tpu.Solver(JPendulum(N=4), jp).solve(x0)
    with pytest.raises(Exception, match=r"exceeded maximum 0.001 \(incorrect derivatives\?\)"):
        pygradflow_torch.Solver(TPendulum(N=4), tp, device="cpu").solve(tensor(x0))


def test_initial_point_on_another_device_is_rejected():
    tp = params_pair(**ANCHOR)[1]
    solver = pygradflow_torch.Solver(TPendulum(N=2), tp, device="cpu")
    x0 = torch.zeros(TPendulum(N=2).num_vars, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="initial point on meta"):
        solver.solve(x0)


def _entry_point(name):
    from pygradflow_torch.parallel import BatchedSolver

    return {"Solver": pygradflow_torch.Solver, "BatchedSolver": BatchedSolver}[name]


@pytest.mark.parametrize("name", ["Solver", "BatchedSolver"])
def test_entry_point_defaults_to_the_card(name):
    """Without ``device`` the solve runs on the current CUDA device; with no
    card the constructor raises and names the way to the CPU."""
    make = _entry_point(name)
    tp = params_pair(**ANCHOR)[1]
    if torch.cuda.is_available():
        assert make(TPendulum(N=2), tp).device == torch.device("cuda", torch.cuda.current_device())
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make(TPendulum(N=2), tp)
    assert make(TPendulum(N=2), tp, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("name", ["Solver", "BatchedSolver"])
def test_entry_point_without_a_card_raises(name, monkeypatch):
    """No fallback to the CPU, whatever machine the test runs on."""
    make = _entry_point(name)
    tp = params_pair(**ANCHOR)[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(TPendulum(N=2), tp)


def test_hs71_constrained_matches_jax():
    """Ranged and shifted equality constraints: the slack transform on the
    whole path, with the mixed-precision tier."""
    from tests.problems import HS71Constrained as JHS71Constrained

    from .torch_parity import HS71Constrained

    x0 = np.array([1.0, 5.0, 5.0, 1.0])
    jp, tp = params_pair(**ANCHOR)
    jr = pygradflow_tpu.Solver(JHS71Constrained(), jp).solve(x0)
    tr = pygradflow_torch.Solver(HS71Constrained(), tp, device="cpu").solve(tensor(x0))
    assert jr.status == pygradflow_tpu.SolverStatus.Optimal
    assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == (
        jr.status.name, jr.iterations, jr.num_accepted_steps,
    )
    np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=SOL_TOL)
    np.testing.assert_allclose(numpy(tr.y), jr.y, rtol=0, atol=SOL_TOL)


def test_tame_matches_jax():
    """Every step converges in its first Newton iteration: the controller's
    early branch, which lowers lambda without a second step."""
    from tests.problems import Tame as JTame

    from .torch_parity import Tame

    jp, tp = params_pair(**ANCHOR)
    jr = pygradflow_tpu.Solver(JTame(), jp).solve(np.zeros(2))
    tr = pygradflow_torch.Solver(Tame(), tp, device="cpu").solve(tensor(np.zeros(2)))
    assert jr.status == pygradflow_tpu.SolverStatus.Optimal
    assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == (
        jr.status.name, jr.iterations, jr.num_accepted_steps,
    )
    np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=SOL_TOL)
    assert {c.name(): n for c, n in tr.num_evals.items()} == {
        c.name(): n for c, n in jr.num_evals.items()
    }


def test_computed_step_callback_fires_each_iteration():
    from pygradflow_torch.callbacks import CallbackType

    _, tp = params_pair(**ANCHOR)
    problem = TPendulum(N=8)
    solver = pygradflow_torch.Solver(problem, tp, device="cpu")
    seen = []
    handle = solver.callbacks.register(
        CallbackType.ComputedStep, lambda prev, nxt, accept: seen.append(accept)
    )
    res = solver.solve(tensor(problem.x0_trajectory()))
    assert len(seen) == res.iterations
    assert sum(seen) == res.num_accepted_steps
    handle.unregister()
    assert solver.callbacks.empty(CallbackType.ComputedStep)
