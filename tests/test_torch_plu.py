"""The port's LU tier (``linalg/plu.py``) against the JAX package's, and the
single ``Solver`` at ``Params()`` (the LU default) on the verify anchors.

Both factor in f64 with the same pivot rule and the same rank-1 updates,
so the pivots are equal and the factors agree to 1e-12; the solves use the
same column sweeps up to n = 16 and library triangular solves above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch.linalg import linear_solver
from pygradflow_torch.linalg.plu import plu_factor, plu_solve, plu_solve_trans
from pygradflow_torch.params import LinearSolverType
from pygradflow_tpu.linalg.plu import plu_factor as jax_plu_factor
from pygradflow_tpu.linalg.plu import plu_solve as jax_plu_solve
from pygradflow_tpu.linalg.plu import plu_solve_trans as jax_plu_solve_trans

from .torch_parity import numpy, params_pair, tensor

TOL = 1e-12  # f64 on both sides, the same operations
SOLVE_TOL = 1e-10
SOL_TOL = 1e-6


def _matrices(n, lead):
    rng = np.random.default_rng(n)
    return rng.standard_normal(lead + (n, n)), rng.standard_normal(lead + (n,))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "batched"])
@pytest.mark.parametrize("n", [2, 5, 16, 17, 40])
def test_plu_matches_jax(n, lead):
    a, b = _matrices(n, lead)
    ours = plu_factor(tensor(a))
    ref = jax_plu_factor(jnp.asarray(a))
    np.testing.assert_array_equal(numpy(ours.perm), np.asarray(ref.perm))
    np.testing.assert_allclose(numpy(ours.lu), np.asarray(ref.lu), rtol=TOL, atol=TOL)
    for ours_solve, jax_solve in ((plu_solve, jax_plu_solve), (plu_solve_trans, jax_plu_solve_trans)):
        x = numpy(ours_solve(ours, tensor(b)))
        np.testing.assert_allclose(x, np.asarray(jax_solve(ref, jnp.asarray(b))), rtol=SOLVE_TOL, atol=SOLVE_TOL)
    np.testing.assert_allclose(np.einsum("...ij,...j->...i", a, numpy(plu_solve(ours, tensor(b)))), b, atol=1e-9)
    np.testing.assert_allclose(
        np.einsum("...ji,...j->...i", a, numpy(plu_solve_trans(ours, tensor(b)))), b, atol=1e-9
    )


def test_argmax_takes_the_first_maximum():
    """The pivot rule rests on it: ``torch.argmax`` returns the first of
    equal maxima, as ``jnp.argmax`` does."""
    col = [1.0, 3.0, -3.0, 3.0, 2.0]
    assert int(torch.argmax(torch.tensor(col).abs())) == int(jnp.argmax(jnp.abs(jnp.asarray(col)))) == 1


@pytest.mark.parametrize("lead", [(), (4,)], ids=["single", "batched"])
def test_plu_pivots_on_ties_match_jax(lead):
    """Small integers: many columns hold several entries of equal magnitude."""
    a = np.random.default_rng(2).integers(-2, 3, size=lead + (9, 9)).astype(np.float64)
    a += 9.0 * np.eye(9) * (np.arange(9) % 2)  # keep it nonsingular
    ours = plu_factor(tensor(a))
    ref = jax_plu_factor(jnp.asarray(a))
    np.testing.assert_array_equal(numpy(ours.perm), np.asarray(ref.perm))
    np.testing.assert_allclose(numpy(ours.lu), np.asarray(ref.lu), rtol=TOL, atol=TOL)


def test_zero_pivot_gives_nan_in_its_lane_only():
    a, b = _matrices(6, (3,))
    a[1, :, 2] = 0.0  # a zero column: singular
    ours = plu_factor(tensor(a))
    ref = jax_plu_factor(jnp.asarray(a))
    assert np.isnan(np.asarray(ref.lu)[1]).any()
    assert torch.isnan(ours.lu[1]).any()
    assert torch.isfinite(ours.lu[[0, 2]]).all()
    x = plu_solve(ours, tensor(b))
    assert torch.isnan(x[1]).any() and torch.isfinite(x[[0, 2]]).all()


def test_lu_tier_through_the_factory():
    a, b = _matrices(7, ())
    lin = linear_solver(LinearSolverType.LU)
    fact = lin.factor(tensor(a))
    np.testing.assert_allclose(a @ numpy(lin.solve(fact, tensor(b))), b, atol=1e-10)
    np.testing.assert_allclose(a.T @ numpy(lin.solve_trans(fact, tensor(b))), b, atol=1e-10)
    assert lin.num_neg_eigvals is None


def _anchor(name):
    import tests.problems as jprob

    from . import torch_parity as tprob

    x0 = {
        "rosenbrock": np.array([0.0, 0.0]),
        "hs71": np.array([1.0, 5.0, 5.0, 1.0, 0.0]),
        "tame": np.array([0.0, 0.0]),
    }[name]
    cls = {"rosenbrock": "Rosenbrock", "hs71": "HS71", "tame": "Tame"}[name]
    return getattr(jprob, cls)(), getattr(tprob, cls)(), x0


@pytest.mark.parametrize(
    "name,counts", [("rosenbrock", (30, 25)), ("hs71", (19, 13)), ("tame", (7, 7))]
)
def test_solver_at_default_params_matches_jax(name, counts):
    """The anchors of the verify recipe, through the default LU tier."""
    jprob, tprob, x0 = _anchor(name)
    jp, tp = params_pair()
    jr = pygradflow_tpu.Solver(jprob, jp).solve(x0)
    tr = pygradflow_torch.Solver(tprob, tp, device="cpu").solve(tensor(x0))
    assert jr.status == pygradflow_tpu.SolverStatus.Optimal
    assert tr.status.name == jr.status.name
    assert (jr.iterations, jr.num_accepted_steps) == counts
    assert (tr.iterations, tr.num_accepted_steps) == counts
    np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=SOL_TOL)
    np.testing.assert_allclose(numpy(tr.y), jr.y, rtol=0, atol=SOL_TOL)
    assert {c.name(): n for c, n in tr.num_evals.items()} == {
        c.name(): n for c, n in jr.num_evals.items()
    }
