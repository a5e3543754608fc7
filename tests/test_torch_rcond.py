"""The port's reciprocal-condition estimate against the JAX package
(``tests/test_rcond.py``).

JAX draws its probe vectors with ``jax.random.PRNGKey(42)``, which torch
cannot reproduce; the port draws its own (``cond_estimate.probe_vectors``).
With JAX's probes put in their place the two estimates agree to 1e-10
relative on seeded matrices, and the solves' ``final_rcond`` to 1e-8.
With the port's own probes the counts are equal and ``final_rcond``
within ``PROBE_FACTOR`` of JAX's: the estimates of HS71, ``LaplacianQP(199)``
and the pendulum at N = 16 differ by at most 1.27x."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch.linalg import LinearSolverType, linear_solver
from pygradflow_torch.parallel import BatchedSolver
from pygradflow_torch.runners.control import PendulumControl as TPendulum
from pygradflow_torch.step import cond_estimate
from pygradflow_tpu import linalg as j_linalg
from pygradflow_tpu.parallel import BatchedSolver as JBatchedSolver
from pygradflow_tpu.runners.control import PendulumControl as JPendulum
from pygradflow_tpu.step import cond_estimate as j_cond_estimate

from .torch_parity import ANCHOR, PALLAS_TOL, assert_same_solve, numpy, params_pair, saddle, solve_both, tensor

PROBE_FACTOR = 3.0
"""``final_rcond`` of the port's probes against JAX's: within this factor."""

HS71_X0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])


def jax_probes(size, dtype, device):
    """The probes of ``pygradflow_tpu/step/cond_estimate.py``, as tensors."""
    kx, ky = jax.random.split(jax.random.PRNGKey(cond_estimate.SEED))
    pair = []
    for key in (kx, ky):
        v = jax.random.normal(key, (size,), dtype=jnp.float64)
        pair.append(torch.as_tensor(np.asarray(v / jnp.linalg.norm(v)), dtype=dtype, device=device))
    return tuple(pair)


@pytest.fixture
def with_jax_probes(monkeypatch):
    monkeypatch.setattr(cond_estimate, "probe_vectors", jax_probes)


def test_required_its_as_jax():
    for size in (2, 644, 1284, 61, 5000):
        assert cond_estimate.required_its(size) == j_cond_estimate.required_its(size)
    assert [cond_estimate.required_its(s) for s in (2, 644, 1284)] == [4, 6, 6]


def test_probe_vectors_are_seeded_unit_vectors():
    x, y = cond_estimate.probe_vectors(50, torch.float64, "cpu")
    x2, y2 = cond_estimate.probe_vectors(50, torch.float64, "cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    np.testing.assert_allclose([float(torch.linalg.vector_norm(v)) for v in (x, y)], [1.0, 1.0], rtol=1e-15)
    assert not torch.allclose(x, y)


def _matrix(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "LU":
        return rng.standard_normal((40, 40)) + 8.0 * np.eye(40)
    return saddle(rng, 40, 20)


@pytest.mark.parametrize("kind", ["LU", "LDLT", "PallasLDLT"])
def test_estimate_rcond_matches_jax(kind, with_jax_probes):
    a = _matrix(kind, seed={"LU": 1, "LDLT": 2, "PallasLDLT": 3}[kind])
    jlin = j_linalg.linear_solver(getattr(j_linalg.LinearSolverType, kind), symmetric=kind != "LU")
    tlin = linear_solver(getattr(LinearSolverType, kind), symmetric=kind != "LU")
    jfact, tfact = jlin.factor(jnp.asarray(a)), tlin.factor(tensor(a))
    ref = j_cond_estimate.estimate_rcond(
        jnp.asarray(a), lambda r: jlin.solve(jfact, r), lambda r: jlin.solve_trans(jfact, r)
    )
    ours = cond_estimate.estimate_rcond(tensor(a), lambda r: tlin.solve(tfact, r), lambda r: tlin.solve_trans(tfact, r))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-10)
    # the estimate is of the order of the true value
    true = 1.0 / np.linalg.cond(a)
    assert true / 10.0 < float(ours) < 10.0 * true


def test_estimate_rcond_on_lanes_equals_single():
    mats = [_matrix("LDLT", seed) for seed in (4, 5, 6)]
    lin = linear_solver(LinearSolverType.LDLT, symmetric=True)
    stack = tensor(np.stack(mats))
    fact = lin.factor(stack)
    lanes = cond_estimate.estimate_rcond(stack, lambda r: lin.solve(fact, r), lambda r: lin.solve_trans(fact, r))
    assert lanes.shape == (3,)
    for i, a in enumerate(mats):
        f = lin.factor(tensor(a))
        single = cond_estimate.estimate_rcond(tensor(a), lambda r: lin.solve(f, r), lambda r: lin.solve_trans(f, r))
        np.testing.assert_allclose(float(lanes[i]), float(single), rtol=1e-12)


def _hs71():
    from tests.problems import HS71 as JHS71

    from .torch_parity import HS71

    return (JHS71(), HS71()), (HS71_X0, np.zeros(2)), {}


def _laplacian():
    from tests.problems import LaplacianQP as JLaplacianQP

    from .torch_parity import LaplacianQP

    return (JLaplacianQP(n=199), LaplacianQP(n=199)), (None, None), dict(
        step_solver_type="Symmetric", linear_solver_type="LDLT"
    )


def _pendulum():
    return (JPendulum(N=16), TPendulum(N=16)), (JPendulum(N=16).x0_trajectory(), None), dict(ANCHOR)


CASES = {"HS71": (_hs71, (19, 13)), "LaplacianQP": (_laplacian, (5, 5)), "pendulum": (_pendulum, (30, 15))}


@pytest.mark.parametrize("name", list(CASES))
def test_final_rcond_matches_jax(name, monkeypatch):
    """Equal counts and solutions, ``final_rcond`` within PROBE_FACTOR with
    the port's probes and to 1e-8 with JAX's."""
    make, counts = CASES[name]
    (jprob, tprob), (x0, y0), kwargs = make()
    jr, tr = solve_both(jprob, tprob, x0, y0, report_rcond=True, **kwargs)
    assert (jr.status.name, jr.iterations, jr.num_accepted_steps) == ("Optimal",) + counts
    assert_same_solve(tr, jr, PALLAS_TOL if name == "pendulum" else 1e-8)
    assert np.isfinite(tr.final_rcond) and 0.0 < tr.final_rcond <= 1.0
    ratio = tr.final_rcond / jr.final_rcond
    assert 1.0 / PROBE_FACTOR <= ratio <= PROBE_FACTOR

    monkeypatch.setattr(cond_estimate, "probe_vectors", jax_probes)
    _, tp = params_pair(report_rcond=True, **kwargs)
    tr = pygradflow_torch.Solver(tprob, tp, device="cpu").solve(
        None if x0 is None else tensor(x0), None if y0 is None else tensor(y0)
    )
    np.testing.assert_allclose(tr.final_rcond, jr.final_rcond, rtol=1e-8)


def test_rcond_nan_when_off():
    (jprob, tprob), (x0, y0), _ = _hs71()
    jr, tr = solve_both(jprob, tprob, x0, y0)
    assert np.isnan(tr.final_rcond) and np.isnan(jr.final_rcond)


def test_schur_rcond_stays_nan():
    """The Schur tiers do not estimate (``schur.py``, as in JAX)."""
    from pygradflow_torch.runners.control import PendulumControlInterleaved

    p = PendulumControlInterleaved(N=8)
    params = pygradflow_torch.Params(
        step_solver_type="Schur", schur_block_size=3, report_rcond=True, iteration_limit=3000, validate_input=False
    )
    r = pygradflow_torch.Solver(p, params, device="cpu").solve(p.x0_trajectory())
    assert r.status.name == "Optimal" and np.isnan(r.final_rcond)


def test_batched_rcond_per_lane(with_jax_probes):
    """Three perturbed HS71 lanes: each lane's rcond equals the JAX single
    ``Solver``'s ``final_rcond`` on its instance (to 1e-8, JAX's probes)
    and the port's own single ``Solver``'s (to 1e-12)."""
    (jprob, tprob), _, _ = _hs71()
    x0s = np.tile(HS71_X0, (3, 1))
    x0s[1, 1], x0s[2, 2] = 4.0, 4.5
    jp, tp = params_pair(report_rcond=True)
    tr = BatchedSolver(tprob, tp, device="cpu").solve(x0s, np.zeros((3, 2)))
    jr = JBatchedSolver(jprob, jp).solve(x0s, np.zeros((3, 2)))
    np.testing.assert_array_equal(numpy(tr.iterations), jr.iterations)
    assert tr.rcond.shape == (3,) and torch.isfinite(tr.rcond).all()
    for lane in range(3):
        jsingle = pygradflow_tpu.Solver(jprob, jp).solve(x0s[lane], np.zeros(2))
        tsingle = pygradflow_torch.Solver(tprob, tp, device="cpu").solve(tensor(x0s[lane]), tensor(np.zeros(2)))
        np.testing.assert_allclose(float(tr.rcond[lane]), jsingle.final_rcond, rtol=1e-8)
        np.testing.assert_allclose(float(tr.rcond[lane]), tsingle.final_rcond, rtol=1e-12)
