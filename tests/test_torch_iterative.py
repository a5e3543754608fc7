"""The port's iterative linear solvers against the JAX package: MINRES
(``pygradflow_tpu/linalg/minres.py``) and GMRES (``jax.scipy.sparse.linalg.gmres``
as the JAX package calls it, ``rtol = atol = 1e-12``, ``solve_method="batched"``)
on seeded symmetric-indefinite and nonsymmetric systems, to 1e-10 relative;
MINRES bitwise independent of how often it reads ``done`` on the host; the
linear-solver sweep of ``tests/test_solver.py`` on Tame; the pendulum at
N = 16 under the Symmetric step solver with each of them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygradflow_torch.linalg import LinearSolverError, LinearSolverType, linear_solver
from pygradflow_torch.linalg.gmres import gmres
from pygradflow_torch.linalg.minres import minres
from pygradflow_torch.runners.control import PendulumControl as TPendulum
from pygradflow_tpu import linalg as j_linalg
from pygradflow_tpu.runners.control import PendulumControl as JPendulum

from .torch_parity import ANCHOR, PALLAS_TOL, Tame, assert_same_solve, numpy, solve_both, tensor

REL_TOL = 1e-10


def _system(kind, n, seed):
    """A seeded, well-posed system: symmetric indefinite (eigenvalues of
    both signs, away from 0) or nonsymmetric (diagonally shifted)."""
    rng = np.random.default_rng(seed)
    if kind == "symmetric":
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        eig = rng.uniform(1.0, 10.0, n) * np.where(np.arange(n) % 3 == 0, -1.0, 1.0)
        a = (q * eig) @ q.T
        a = 0.5 * (a + a.T)
    else:
        a = rng.standard_normal((n, n)) + 2.0 * np.sqrt(n) * np.eye(n)
    return a, rng.standard_normal(n), 0.1 * rng.standard_normal(n)


def _rel(ours, ref):
    ours, ref = numpy(ours), np.asarray(ref)
    return np.linalg.norm(ours - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("n", [8, 64])
def test_minres_matches_jax(n, warm):
    a, b, x0 = _system("symmetric", n, seed=n)
    x0 = x0 if warm else None
    ref = j_linalg.minres(jnp.asarray(a), jnp.asarray(b), x0=None if x0 is None else jnp.asarray(x0))
    ours = minres(tensor(a), tensor(b), x0=None if x0 is None else tensor(x0))
    assert _rel(ours, ref) <= REL_TOL
    np.testing.assert_allclose(a @ numpy(ours), b, rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind", ["symmetric", "nonsymmetric"])
@pytest.mark.parametrize("n", [8, 64])
def test_gmres_matches_jax(n, kind):
    a, b, x0 = _system(kind, n, seed=100 + n)
    jlin = j_linalg.linear_solver(j_linalg.LinearSolverType.GMRES)
    tlin = linear_solver(LinearSolverType.GMRES)
    for init in (None, x0):
        ref = jlin.solve(jnp.asarray(a), jnp.asarray(b), initial_sol=None if init is None else jnp.asarray(init))
        ours = tlin.solve(tensor(a), tensor(b), initial_sol=None if init is None else tensor(init))
        assert _rel(ours, ref) <= REL_TOL
    ref_t = jlin.solve_trans(jnp.asarray(a), jnp.asarray(b))
    assert _rel(tlin.solve_trans(tensor(a), tensor(b)), ref_t) <= REL_TOL


@pytest.mark.parametrize("solver", ["minres", "gmres"])
def test_lanes_equal_single_systems(solver):
    """A (B, n, n) stack: each lane as its system solved alone, the lanes
    that converge first frozen while the others run."""
    kind = "symmetric" if solver == "minres" else "nonsymmetric"
    systems = [_system(kind, n=24, seed=s) for s in range(3)]
    a = tensor(np.stack([s[0] * (1.0 + 10.0 * i) for i, s in enumerate(systems)]))
    b = tensor(np.stack([s[1] for s in systems]))
    fn = minres if solver == "minres" else gmres
    stacked = fn(a, b)
    for lane in range(3):
        np.testing.assert_allclose(numpy(stacked[lane]), numpy(fn(a[lane], b[lane])), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "lanes"])
def test_minres_bitwise_independent_of_check_every(batched):
    """``done`` read on the host every iteration or every 16: equal bits,
    since an iteration that starts with ``done`` set changes nothing."""
    systems = [_system("symmetric", n=40, seed=7 + s) for s in range(3)]
    a = tensor(np.stack([s[0] for s in systems]))
    b = tensor(np.stack([s[1] for s in systems]))
    x0 = tensor(np.stack([s[2] for s in systems]))
    if not batched:
        a, b, x0 = a[0], b[0], x0[0]
    every = minres(a, b, x0=x0, check_every=1)
    assert torch.equal(every, minres(a, b, x0=x0, check_every=16))
    assert torch.equal(every, minres(a, b, x0=x0, check_every=5))


def test_minres_requires_symmetric():
    with pytest.raises(LinearSolverError):
        linear_solver(LinearSolverType.MINRES, symmetric=False)


@pytest.mark.parametrize("linear_solver_type", ["LU", "LDLT", "MINRES", "GMRES"])
def test_linear_solver_sweep_matches_jax(linear_solver_type):
    """``tests/test_solver.py::test_linear_solver_sweep`` on Tame: 7/7."""
    from tests.problems import Tame as JTame

    jr, tr = solve_both(
        JTame(), Tame(), np.zeros(2), linear_solver_type=linear_solver_type, step_solver_type="Symmetric"
    )
    assert (jr.status.name, jr.iterations, jr.num_accepted_steps) == ("Optimal", 7, 7)
    assert_same_solve(tr, jr)


@pytest.mark.parametrize("linear_solver_type,counts", [("MINRES", (30, 15)), ("GMRES", (22, 15))])
def test_pendulum_iterative_matches_jax(linear_solver_type, counts):
    """The pendulum at N = 16 (KKT 84) under the Symmetric step solver:
    MINRES takes the direct solves' 30/15, GMRES 22/15 in both packages."""
    x0 = JPendulum(N=16).x0_trajectory()
    kwargs = dict(ANCHOR, linear_solver_type=linear_solver_type, step_solver_type="Symmetric")
    jr, tr = solve_both(JPendulum(N=16), TPendulum(N=16), x0, **kwargs)
    assert (jr.status.name, jr.iterations, jr.num_accepted_steps) == ("Optimal",) + counts
    assert_same_solve(tr, jr, PALLAS_TOL)
