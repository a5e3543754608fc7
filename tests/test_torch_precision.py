"""``Precision.Single`` in the port against the JAX package: ``Solver`` on
the LU tier and on the mixed-precision LDL^T tier (B1's plain version),
``BatchedSolver`` lane by lane, ``IntegrationSolver``, and the f32 linear
algebra underneath.

Both packages get the same seeded numpy inputs under
``Params(precision=Single, opt_tol=1e-4, lamb_min=1e-6)``, ``bench.py``'s
f32 settings.  Counts must be equal; x within 1e-4 on the small problems,
within 1e-2 on the pendulum, where f32 ends 1e-3 from the other package's
point along the flat directions of the control problem.  Every result is
f32: the single path drops to f64 nowhere.
"""

import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch.integration import IntegrationSolver
from pygradflow_torch.integration.integrator import FACTOR_QUANTUM, controller_factor
from pygradflow_torch.parallel import BatchedSolver
from pygradflow_torch.runners.control import PendulumControl as TPendulum
from pygradflow_tpu.integration import IntegrationSolver as JIntegrationSolver
from pygradflow_tpu.parallel import BatchedSolver as JBatchedSolver
from pygradflow_tpu.runners.control import PendulumControl as JPendulum

from . import problems as jprob
from . import torch_parity as tprob
from .torch_parity import ANCHOR, numpy, params_pair, tensor

SINGLE = dict(precision="Single", opt_tol=1e-4, lamb_min=1e-6)
X_TOL = 1e-4
PENDULUM_X_TOL = 1e-2
ROSENBROCK_STARTS = np.random.default_rng(0).uniform(-1.5, 1.5, (8, 2))
"""``bench.py:55-57``'s first 8 starts."""


def _single_solve(tproblem, x0, y0=None, **kwargs):
    _, tp = params_pair(**SINGLE, **kwargs)
    return pygradflow_torch.Solver(tproblem, tp, device="cpu").solve(
        tensor(x0), None if y0 is None else tensor(y0)
    )


@pytest.mark.parametrize(
    "name,counts",
    [("rosenbrock", (29, 24)), ("hs71", (18, 12)), ("tame", (3, 3))],
)
def test_single_solver_matches_jax(name, counts):
    inst = getattr(jprob, f"{name}_instance")()
    tproblem = {"rosenbrock": tprob.Rosenbrock, "hs71": tprob.HS71, "tame": tprob.Tame}[name]()
    jp, _ = params_pair(**SINGLE)
    jr = pygradflow_tpu.Solver(inst.problem, jp).solve(inst.x_0, inst.y_0)
    tr = _single_solve(tproblem, np.asarray(inst.x_0), np.asarray(inst.y_0))
    assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == (
        jr.status.name, jr.iterations, jr.num_accepted_steps,
    ) == ("Optimal",) + counts
    assert tr.num_penalty_changes == jr.num_penalty_changes
    assert tr.x.dtype == tr.y.dtype == torch.float32
    np.testing.assert_allclose(numpy(tr.x), np.asarray(jr.x), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(numpy(tr.y), np.asarray(jr.y), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(numpy(tr.x), inst.x_opt, atol=1e-3)


def test_single_quadratic_problem_matches_jax():
    """A ``QuadraticProblem`` with inequality constraints in f32: its f64
    data meets the f32 point in f64, as JAX promotes it, and the slacks join
    the constraint values in their dtype."""
    from pygradflow_torch.problem import QuadraticProblem
    from pygradflow_tpu.problem import QuadraticProblem as JQuadraticProblem

    rng = np.random.default_rng(2)
    n = 6
    h = rng.standard_normal((n, n))
    data = (h @ h.T + n * np.eye(n), rng.standard_normal(n), rng.standard_normal((2, n)),
            np.zeros(2), np.ones(2), -np.ones(n), np.ones(n))
    jp, tp = params_pair(**SINGLE)
    jr = pygradflow_tpu.Solver(JQuadraticProblem(*data), jp).solve(np.zeros(n))
    tr = pygradflow_torch.Solver(QuadraticProblem(*data), tp, device="cpu").solve(np.zeros(n))
    assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == (
        jr.status.name, jr.iterations, jr.num_accepted_steps,
    ) == ("Optimal", 11, 5)
    assert tr.x.dtype == torch.float32
    np.testing.assert_allclose(numpy(tr.x), np.asarray(jr.x), rtol=0, atol=X_TOL)


@pytest.mark.parametrize("N,counts", [(8, (12, 9)), (16, (25, 13))])
def test_single_pendulum_on_pallas_ldlt_matches_jax(N, counts):
    """The pendulum on the LDL^T tier in f32: the factor is B1's plain
    version on the CPU, the JAX kernel in interpret mode, and the refinement
    runs in f32 in both."""
    jp, tp = params_pair(**SINGLE, **ANCHOR)
    x0 = np.asarray(JPendulum(N=N).x0_trajectory())
    jr = pygradflow_tpu.Solver(JPendulum(N=N), jp).solve(x0)
    tr = pygradflow_torch.Solver(TPendulum(N=N), tp, device="cpu").solve(tensor(x0))
    assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == (
        jr.status.name, jr.iterations, jr.num_accepted_steps,
    ) == ("Optimal",) + counts
    assert tr.x.dtype == torch.float32
    np.testing.assert_allclose(numpy(tr.x), np.asarray(jr.x), rtol=0, atol=PENDULUM_X_TOL)


def test_single_batched_lanes_match_jax_and_single():
    """The 8 Rosenbrock lanes of ``bench.py``'s f32 headline.  Each port
    lane equals the port's single ``Solver`` on its start and the JAX
    package's single ``Solver``; all but lane 6 equal the JAX lane too.
    Lane 6 stops on the edge of opt_tol: at iteration 6 its residual is
    within rounding of 1e-4, and JAX's vmapped lane, whose fused f32
    arithmetic rounds differently from its own single solve, stops there
    (6), where both packages' single solves take one more step (7)."""
    jp, tp = params_pair(**SINGLE)
    jr = JBatchedSolver(jprob.Rosenbrock(), jp).solve(ROSENBROCK_STARTS)
    tr = BatchedSolver(tprob.Rosenbrock(), tp, device="cpu").solve(ROSENBROCK_STARTS)
    assert tr.x.dtype == torch.float32
    assert numpy(tr.iterations).tolist() == [26, 50, 7, 26, 29, 6, 7, 16]
    assert np.asarray(jr.iterations).tolist() == [26, 50, 7, 26, 29, 6, 6, 16]
    assert bool(tr.success.all()) and bool(np.all(jr.success))
    same = [lane for lane in range(8) if lane != 6]
    np.testing.assert_array_equal(numpy(tr.accepted_steps)[same], np.asarray(jr.accepted_steps)[same])
    np.testing.assert_allclose(numpy(tr.x)[same], np.asarray(jr.x)[same], rtol=0, atol=X_TOL)
    for lane in range(8):
        single = _single_solve(tprob.Rosenbrock(), ROSENBROCK_STARTS[lane])
        assert (int(tr.iterations[lane]), int(tr.accepted_steps[lane])) == (
            single.iterations, single.num_accepted_steps,
        )
        np.testing.assert_allclose(numpy(tr.x[lane]), numpy(single.x), rtol=0, atol=X_TOL)
    jl6 = pygradflow_tpu.Solver(jprob.Rosenbrock(), jp).solve(ROSENBROCK_STARTS[6])
    assert (jl6.iterations, jl6.num_accepted_steps) == (int(tr.iterations[6]), int(tr.accepted_steps[6]))
    np.testing.assert_allclose(numpy(tr.x[6]), np.asarray(jl6.x), rtol=0, atol=X_TOL)


def test_single_integration_solver_on_tame_matches_jax():
    """The continuous engine in f32 (host engine): status, segments and x
    equal JAX's.  The step counts part by one step in 622, where JAX's own
    f32 runs from starts 2^-30 to 2^-16 away take 620 to 623 steps (Queue
    C)."""
    kw = dict(iteration_limit=1000, rho=1e-2, **SINGLE)
    jp, tp = params_pair(**kw)
    jr = JIntegrationSolver(jprob.Tame(), jp).solve(np.zeros(2), np.zeros(1))
    tr = IntegrationSolver(tprob.TameExplicit(), tp, device="cpu").solve(np.zeros(2), np.zeros(1))
    assert (tr.status.name, tr.iterations) == (jr.status.name, jr.iterations) == ("Optimal", 7)
    assert tr.x.dtype == torch.float32
    assert abs(tr.num_integration_steps - jr.num_integration_steps) <= 1
    np.testing.assert_allclose(numpy(tr.x), np.asarray(jr.x), rtol=0, atol=1e-3)


def test_single_batched_integration_matches_jax():
    """``BatchedIntegrationSolver`` (the flat engine on lanes) in f32: each
    lane Optimal with JAX's segments and x; the step counts part by a few
    in 600, as the single solves do."""
    from pygradflow_torch.integration import BatchedIntegrationSolver
    from pygradflow_tpu.integration import BatchedIntegrationSolver as JBatchedIntegrationSolver

    kw = dict(iteration_limit=1000, rho=1e-2, **SINGLE)
    jp, tp = params_pair(**kw)
    x0, y0 = np.array([[0.0, 0.0], [0.5, 0.1]]), np.zeros((2, 1))
    jr = JBatchedIntegrationSolver(jprob.Tame(), jp).solve(x0, y0)
    tr = BatchedIntegrationSolver(tprob.TameExplicit(), tp, device="cpu").solve(x0, y0)
    assert tr.x.dtype == torch.float32
    assert numpy(tr.status).tolist() == np.asarray(jr.status).tolist() == [1, 1]
    assert numpy(tr.iterations).tolist() == np.asarray(jr.iterations).tolist()
    np.testing.assert_allclose(numpy(tr.x), np.asarray(jr.x), rtol=0, atol=1e-3)


def test_factor_quantum_is_a_no_op_in_f32():
    """The controller's step factor lies in [0.2, cap]; in f32 its
    multiples of 2^-30 are all the f32 values from 2^-7 up, so the rounding
    changes nothing there."""
    factors = torch.linspace(0.2, 10.0, 100_001, dtype=torch.float32)
    factors = torch.cat([factors, torch.nextafter(factors, torch.tensor(0.0))])
    quantized = torch.round(factors / FACTOR_QUANTUM) * FACTOR_QUANTUM
    assert torch.equal(quantized, factors)
    # 0.9 * err^(-1/3), clipped: unchanged but for the clip
    err = torch.logspace(-6, 2, 1001, dtype=torch.float32)
    ok = torch.ones_like(err, dtype=torch.bool)
    expected = torch.clamp(0.9 * err ** (-1.0 / 3.0), 0.2, 10.0)
    assert torch.equal(controller_factor(err, ok, -1.0 / 3.0, 10.0), expected)


def test_f32_linear_algebra_stays_f32():
    """Under Single the LU tier factors and solves in f32, and the LDL^T
    tier's refinement computes its residual in f32 against the f32 matrix,
    as ``pygradflow_tpu/linalg/pallas_ldlt.py:243-257`` does; both within
    f32 rounding of the JAX package's."""
    import jax.numpy as jnp

    from pygradflow_torch.linalg import linear_solver
    from pygradflow_torch.params import LinearSolverType
    from pygradflow_tpu.linalg import pallas_ldlt as jpl
    from pygradflow_tpu.linalg.plu import plu_factor, plu_solve

    rng = np.random.default_rng(5)
    a = tprob.saddle(rng, 24, 16).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    lu = linear_solver(LinearSolverType.LU)
    x_lu = lu.solve(lu.factor(at), bt)
    assert x_lu.dtype == torch.float32
    x_jlu = np.asarray(plu_solve(plu_factor(jnp.asarray(a)), jnp.asarray(b)))
    assert x_jlu.dtype == np.float32
    np.testing.assert_allclose(numpy(x_lu), x_jlu, rtol=1e-4, atol=1e-5)

    ldl = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)
    x_ldl = ldl.solve(ldl.factor(at), bt)
    assert x_ldl.dtype == torch.float32
    packed = jpl.pallas_ldlt_factor_f32(jnp.asarray(a), interpret=True)
    x_jldl = np.asarray(jpl.refine_solve(packed, jnp.asarray(a), jnp.asarray(b)))
    assert x_jldl.dtype == np.float32
    np.testing.assert_allclose(numpy(x_ldl), x_jldl, rtol=1e-4, atol=1e-5)
    assert float(np.max(np.abs(a @ numpy(x_ldl) - b))) < 1e-4
