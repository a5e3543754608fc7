"""The port's Hock-Schittkowski specs against the JAX package's: every spec's
numbers equal, its objective, constraints, gradient and Jacobian equal to
1e-12 relative at the book start and at 3 seeded points near it (eager
``jax.grad``/``jax.jacfwd`` against ``torch.func``), and full solves on
specs that cover bounds only, equalities, inequalities and log terms
against live JAX runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd

import pygradflow_tpu
from pygradflow_torch import Params, Solver
from pygradflow_torch.runners.hs import HS_BY_NAME, HS_SPECS
from pygradflow_tpu.runners.hs import HS_BY_NAME as J_HS_BY_NAME
from pygradflow_tpu.runners.hs import HS_SPECS as J_HS_SPECS

from .torch_parity import numpy

EVAL_RTOL = 1e-12
"""Values and derivatives of a spec against the JAX one (NaN matches NaN)."""

X_TOL = 1e-8
"""x of a port solve against the JAX one."""

NUMERIC_FIELDS = ("var_lb", "var_ub", "x0", "cons_lb", "cons_ub", "num_eq_cons", "x_opt", "f_opt")


def test_the_suite_is_the_jax_suite():
    assert [s.name for s in HS_SPECS] == [s.name for s in J_HS_SPECS]
    assert len(HS_SPECS) == 80
    assert set(HS_BY_NAME) == set(J_HS_BY_NAME)


def _points(spec):
    """The book start and 3 seeded points near it, clipped to the bounds."""
    x0 = np.asarray(spec.x0, dtype=np.float64)
    rng = np.random.default_rng(sum(map(ord, spec.name)))
    near = [np.clip(x0 + 0.1 * rng.standard_normal(x0.shape), spec.var_lb, spec.var_ub) for _ in range(3)]
    return [x0] + near


def _close(ours, ref, what):
    ref = np.asarray(ref)
    ours = numpy(ours)
    assert ours.shape == ref.shape, what
    np.testing.assert_allclose(ours, ref, rtol=EVAL_RTOL, atol=0, equal_nan=True, err_msg=what)


@pytest.mark.parametrize("name", [s.name for s in J_HS_SPECS])
def test_spec_matches_jax(name):
    ours, ref = HS_BY_NAME[name], J_HS_BY_NAME[name]
    for field in NUMERIC_FIELDS:
        a, b = getattr(ours, field), getattr(ref, field)
        if b is None:
            assert a is None, field
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)
    assert (ours.cons is None) == (ref.cons is None)
    for x in _points(ref):
        xt, xj = torch.tensor(x), jnp.asarray(x)
        _close(ours.obj(xt), ref.obj(xj), "obj")
        _close(grad(ours.obj)(xt), jax.grad(ref.obj)(xj), "grad")
        if ref.cons is not None:
            _close(ours.cons(xt), ref.cons(xj), "cons")
            _close(jacfwd(ours.cons)(xt), jax.jacfwd(ref.cons)(xj), "jac")


# bounds only (hs1); equalities (hs6, hs112); equalities mixed with
# inequalities (hs14, hs71); inequalities with bounds (hs35, hs76, hs108);
# log terms (hs112)
SOLVED_AGAINST_JAX = ["hs1", "hs6", "hs14", "hs35", "hs71", "hs76", "hs108", "hs112"]


@pytest.mark.parametrize("name", SOLVED_AGAINST_JAX)
def test_solve_matches_jax(name):
    spec, jspec = HS_BY_NAME[name], J_HS_BY_NAME[name]
    ours = Solver(spec.problem(), Params(), device="cpu").solve(spec.x0)
    ref = pygradflow_tpu.Solver(jspec.problem(), pygradflow_tpu.Params()).solve(jspec.x0)
    assert (ours.status.name, ours.iterations, ours.num_accepted_steps) == (
        ref.status.name, ref.iterations, ref.num_accepted_steps,
    )
    np.testing.assert_allclose(numpy(ours.x), np.asarray(ref.x), rtol=0, atol=X_TOL)
