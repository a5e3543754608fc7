"""The live display, derivative checks and the profiler in the port.

The three cases of ``tests/test_display.py`` on the port's logger; the
port's rows against the JAX package's, row by row, to the display's 4
digits; the derivative checks of ``tests/test_solver.py`` with the invalid
indices the JAX package names; and ``Params.profile_dir``.
"""

import logging
import os

import numpy as np
import pytest
import torch

import pygradflow_tpu
from pygradflow_torch import DerivCheck, Params, Problem, Solver
from pygradflow_torch.deriv_check import DerivError
from pygradflow_torch.integration import IntegrationSolver
from pygradflow_tpu.deriv_check import DerivError as JDerivError

from . import problems as jprob
from . import torch_parity as tprob
from .torch_parity import WrongGradient, params_pair

LOGGER = "gradflow_torch"
HS71_X0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])
HS71_Y0 = np.zeros(2)


def _hs71(params):
    return Solver(tprob.HS71(), params, device="cpu").solve(HS71_X0, HS71_Y0)


def test_display_rows(caplog):
    params = Params(display=True, display_interval=0.0)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        result = _hs71(params)
    assert result.success
    text = caplog.text
    for col in ["aug_lag", "cons_viol", "stat_res", "lamb", "rho", "accept"]:
        assert col in text
    assert (" yes" in text) or (" no" in text)


def test_inner_newton_debug_rows(caplog):
    """DEBUG adds indented rows of the inner Newton iterations (reference
    ``display.py:307-315``): a header and one row per inner step."""
    params = Params(display=True, display_interval=0.0)
    with caplog.at_level(logging.DEBUG, logger=LOGGER):
        result = _hs71(params)
    assert result.success
    debug_lines = [r.message for r in caplog.records if r.levelno == logging.DEBUG]
    assert any("residuum" in ln and "dist" in ln for ln in debug_lines)
    rows = [ln for ln in debug_lines if ln.startswith("     ") and "e-" in ln or "e+" in ln]
    assert len(rows) >= 2


def test_inner_newton_rows_absent_at_info(caplog):
    """The DEBUG gate is decided once: at INFO no inner row appears."""
    params = Params(display=True, display_interval=0.0)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        result = _hs71(params)
    assert result.success
    assert not any("residuum" in r.message for r in caplog.records)


def _rows(records, first_column):
    """The data rows of a display: header lines dropped, each row split
    into its cells."""
    rows = []
    for r in records:
        cells = r.getMessage().split()
        if cells and cells[0] != first_column and cells[0].lstrip("-").isdigit():
            rows.append(cells)
    return rows


def _same_cells(ours, theirs, columns):
    assert len(ours) == len(theirs)
    for k in columns:
        a, b = ours[k], theirs[k]
        if a in ("yes", "no") or b in ("yes", "no"):
            assert a == b
        else:
            assert np.isclose(float(a), float(b), rtol=1e-4, atol=1e-12), (k, a, b)


@pytest.mark.parametrize("precision", ["Double", "Single"])
def test_display_rows_equal_jax(caplog, precision):
    """The outer rows of HS71, and the inner rows at DEBUG, equal JAX's row
    by row to 4 digits, every column in f64.  In f32 the two trajectories
    part in their last bits, which the columns that cancel (the violation,
    the nonlinearity, the step lengths, lambda from the PI controller near
    convergence, the inner residuals) amplify to 1e-3 and more in the last
    iterations; there the counts, the iteration and active-set columns,
    the acceptance and the Lagrangian and objective columns are held.  A
    solve with the display gives the counts of one without it."""
    extra = {} if precision == "Double" else dict(opt_tol=1e-4, lamb_min=1e-6)
    jp, tp = params_pair(display=True, display_interval=0.0, precision=precision, **extra)
    inst = jprob.hs71_instance()
    with caplog.at_level(logging.DEBUG, logger="gradflow_tpu"), caplog.at_level(logging.DEBUG, logger=LOGGER):
        jr = pygradflow_tpu.Solver(inst.problem, jp).solve(inst.x_0, inst.y_0)
        tr = _hs71(tp)
    jrecords = [r for r in caplog.records if r.name == "gradflow_tpu"]
    trecords = [r for r in caplog.records if r.name == LOGGER]
    for level, f32_columns in ((logging.INFO, (0, 1, 2, 5, -1)), (logging.DEBUG, (0, 3))):
        theirs = _rows([r for r in jrecords if r.levelno == level], "iter")
        ours = _rows([r for r in trecords if r.levelno == level], "iter")
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            _same_cells(a, b, range(len(a)) if precision == "Double" else f32_columns)
    assert len(_rows([r for r in trecords if r.levelno == logging.INFO], "iter")) == tr.iterations
    _, plain = params_pair(precision=precision, **extra)
    quiet = _hs71(plain)
    assert (tr.iterations, tr.num_accepted_steps) == (quiet.iterations, quiet.num_accepted_steps)
    assert (tr.iterations, tr.num_accepted_steps) == (jr.iterations, jr.num_accepted_steps)
    assert torch.equal(tr.x, quiet.x)


def test_integrator_display_rows(caplog):
    """The continuous engine logs one row per segment on the host engine,
    also when the device engine is asked for."""
    params = Params(iteration_limit=1000, rho=1e-2, display=True, display_interval=0.0,
                    integration_device_loop=True)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        result = IntegrationSolver(tprob.TameExplicit(), params, device="cpu").solve(np.zeros(2), np.zeros(1))
    rows = _rows([r for r in caplog.records if r.name == LOGGER], "iter")
    assert result.success and len(rows) == result.iterations == 12
    assert [int(r[0]) for r in rows] == list(range(1, 13))
    assert "free" in caplog.text and "steps" in caplog.text


class WrongHess(Problem):
    def __init__(self):
        super().__init__(np.array([-np.inf] * 2), np.array([np.inf] * 2))

    def obj(self, x):
        return torch.dot(x, x)

    def lag_hess(self, x, y):
        return 2.0 * torch.eye(2, dtype=x.dtype) + torch.tensor([[0.0, 1.0], [0.0, 0.0]], dtype=x.dtype)


def _jax_wrong(kind):
    import jax.numpy as jnp

    class JWrong(pygradflow_tpu.Problem):
        def __init__(self):
            super().__init__(np.array([-np.inf] * 2), np.array([np.inf] * 2))

        def obj(self, x):
            return jnp.dot(x, x)

        if kind == "grad":

            def obj_grad(self, x):
                return (2.0 * x).at[1].add(3.0)

        else:

            def lag_hess(self, x, y):
                return 2.0 * jnp.eye(2) + jnp.array([[0.0, 1.0], [0.0, 0.0]])

    return JWrong()


@pytest.mark.parametrize(
    "kind,check,problem",
    [("grad", "CheckFirst", WrongGradient), ("hess", "CheckSecond", WrongHess), ("grad", "CheckAll", WrongGradient)],
)
def test_deriv_check_names_the_jax_indices(kind, check, problem):
    jp, tp = params_pair(deriv_check=check)
    with pytest.raises(JDerivError) as jexc:
        pygradflow_tpu.Solver(_jax_wrong(kind), jp).solve(np.array([1.0, 1.0]))
    with pytest.raises(DerivError) as exc:
        Solver(problem(), tp, device="cpu").solve(np.array([1.0, 1.0]))
    np.testing.assert_array_equal(exc.value.invalid_indices, jexc.value.invalid_indices)
    np.testing.assert_allclose(exc.value.invalid_findiff, jexc.value.invalid_findiff, rtol=1e-12)
    np.testing.assert_array_equal(exc.value.invalid_deriv, jexc.value.invalid_deriv)
    if kind == "grad":
        assert exc.value.invalid_indices.tolist() == [[0, 1]]


@pytest.mark.parametrize("precision", ["Double", "Single"])
def test_deriv_check_all_passes_on_hs71(caplog, precision):
    params = Params(deriv_check=DerivCheck.CheckAll, precision=precision)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        result = _hs71(params)
    assert result.success
    assert "Finished derivative check" in caplog.text
    assert "Checking Hessian" in caplog.text


def test_profile_dir_holds_a_trace(tmp_path):
    """``Params.profile_dir``: the solve runs under ``torch.profiler`` and
    leaves a Chrome trace there, with the solve's operations in it."""
    trace_dir = tmp_path / "trace"
    result = Solver(tprob.Tame(), Params(profile_dir=str(trace_dir)), device="cpu").solve(np.zeros(2))
    assert result.success
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    text = (trace_dir / files[0]).read_text()
    assert "traceEvents" in text and "aten::" in text
