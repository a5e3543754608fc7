"""``MixedPrecisionSolver`` and ``multistart_solve`` in the port.

The three cases of ``tests/test_mixed.py`` (the f32 bulk plus the f64
polish reaches the optima of a pure f64 batched solve), then the port lane
by lane against the JAX package's ``MixedPrecisionSolver`` on ``bench.py``'s
first 8 Rosenbrock starts, and ``multistart_solve`` against the JAX one on
a problem with four minima written as twins for both packages.
"""

import numpy as np
import pytest
import torch

import pygradflow_tpu
from pygradflow_torch import Params, SolverStatus
from pygradflow_torch.parallel import BatchedSolver, MixedPrecisionSolver, multistart_solve
from pygradflow_tpu.parallel import MixedPrecisionSolver as JMixedPrecisionSolver
from pygradflow_tpu.parallel import multistart_solve as jmultistart_solve

from . import problems as jprob
from . import torch_parity as tprob
from .torch_parity import FourWells, numpy

ROSENBROCK_STARTS = np.random.default_rng(0).uniform(-1.5, 1.5, (8, 2))


def _mixed(problem, params=None):
    return MixedPrecisionSolver(problem, params or Params(), device="cpu")


def test_mixed_rosenbrock_matches_f64_optima():
    x0s = np.random.default_rng(3).uniform(-1.5, 1.5, size=(8, 2))
    params = Params()
    mixed = _mixed(tprob.Rosenbrock(), params)
    res = mixed.solve(x0s)

    assert bool(res.success.all())
    assert res.x.dtype == torch.float64 and mixed.bulk_result.x.dtype == torch.float32
    np.testing.assert_allclose(numpy(res.x), np.ones((8, 2)), atol=1e-5)
    # the final residuals meet the f64 tolerance, not just the f32 one
    assert float(res.total_res.max()) <= params.opt_tol
    # the polish stage is short: warm starts near 1e-4 do not replay the
    # whole trajectory
    bulk_iters = numpy(mixed.bulk_result.iterations)
    polish_iters = numpy(res.iterations) - bulk_iters
    assert (polish_iters >= 1).all()
    assert polish_iters.mean() < bulk_iters.mean()


def test_mixed_hs71_matches_pure_f64():
    inst_x0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])
    rng = np.random.default_rng(5)
    x0s = np.clip(
        inst_x0[None, :] + rng.uniform(-0.1, 0.1, size=(6, 5)),
        np.array([1.0, 1.0, 1.0, 1.0, 0.0]),
        np.array([5.0, 5.0, 5.0, 5.0, 2.0]),
    )
    y0s = np.zeros((6, 2))

    params = Params()
    pure = BatchedSolver(tprob.HS71(), params, device="cpu").solve(x0s, y0s)
    mixed = _mixed(tprob.HS71(), params).solve(x0s, y0s)

    assert bool(pure.success.all()) and bool(mixed.success.all())
    np.testing.assert_allclose(numpy(mixed.x), numpy(pure.x), atol=1e-5)
    np.testing.assert_allclose(numpy(mixed.y), numpy(pure.y), atol=1e-4)
    assert float(mixed.total_res.max()) <= params.opt_tol


def test_mixed_handles_nonfinite_f32_lanes():
    """A lane whose f32 stage ended non-finite restarts the polish from its
    own start instead of poisoning it."""
    mixed = _mixed(tprob.Rosenbrock())
    x0s = np.array([[0.0, 0.0], [0.5, -0.5]])
    orig_solve = mixed.bulk.solve

    def poisoned(x0, y0=None, data=None):
        r = orig_solve(x0, y0, data=data)
        x = r.x.clone()
        x[1] = torch.nan
        return r._replace(x=x)

    mixed.bulk.solve = poisoned
    res = mixed.solve(x0s)
    assert bool(res.success.all())
    np.testing.assert_allclose(numpy(res.x), np.ones((2, 2)), atol=1e-5)


def test_mixed_lanes_match_jax():
    """Bulk and total iterations lane by lane.  Lane 6's bulk stage stops
    on the edge of the f32 opt_tol, where the JAX package's vmapped lane
    stops one iteration before the single solves of both packages
    (``test_torch_precision.py``); its polish takes the same 3 iterations.
    The f32 stages end within f32 rounding of each other, so the final x
    agree to the f64 opt_tol; from the JAX package's own f32 results the
    port's polish gives its x and y to 1e-8."""
    jmixed = JMixedPrecisionSolver(jprob.Rosenbrock(), pygradflow_tpu.Params())
    jr = jmixed.solve(ROSENBROCK_STARTS)
    mixed = _mixed(tprob.Rosenbrock())
    tr = mixed.solve(ROSENBROCK_STARTS)

    assert np.asarray(jr.iterations).tolist() == [29, 53, 10, 29, 32, 9, 9, 19]
    assert numpy(tr.iterations).tolist() == [29, 53, 10, 29, 32, 9, 10, 19]
    bulk = numpy(mixed.bulk_result.iterations)
    jbulk = np.asarray(jmixed.bulk_result.iterations)
    np.testing.assert_array_equal(numpy(tr.iterations) - bulk, np.asarray(jr.iterations) - jbulk)
    assert (numpy(tr.iterations) - bulk == 3).all()
    same = [lane for lane in range(8) if lane != 6]
    np.testing.assert_array_equal(bulk[same], jbulk[same])
    np.testing.assert_array_equal(numpy(tr.accepted_steps)[same], np.asarray(jr.accepted_steps)[same])
    assert [SolverStatus(int(s)).name for s in tr.status] == ["Optimal"] * 8
    np.testing.assert_array_equal(np.asarray(jr.status), numpy(tr.status))
    np.testing.assert_allclose(numpy(tr.x), np.asarray(jr.x), rtol=0, atol=1e-6)

    jbulk_x = np.asarray(jmixed.bulk_result.x, dtype=np.float64)
    jbulk_y = np.asarray(jmixed.bulk_result.y, dtype=np.float64)
    polish = mixed.polish.solve(jbulk_x, jbulk_y)
    np.testing.assert_array_equal(numpy(polish.iterations), np.asarray(jr.iterations) - jbulk)
    np.testing.assert_allclose(numpy(polish.x), np.asarray(jr.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(numpy(polish.y), np.asarray(jr.y), rtol=0, atol=1e-8)


class JFourWells(pygradflow_tpu.Problem):
    """The JAX twin of ``torch_parity.FourWells``."""

    def __init__(self):
        super().__init__(np.full(2, -2.0), np.full(2, 2.0))

    def obj(self, x):
        return (x[0] ** 2 - 1.0) ** 2 + (x[1] ** 2 - 1.0) ** 2 + 0.1 * x[0] + 0.05 * x[1]


def test_multistart_matches_jax():
    x0s = np.random.default_rng(11).uniform(-2.0, 2.0, (32, 2))
    jr = jmultistart_solve(JFourWells(), x0s, pygradflow_tpu.Params())
    tr = multistart_solve(FourWells(), x0s, Params(), device="cpu")

    assert tr.success and jr.success
    assert tr.best_index == jr.best_index
    assert tr.num_optimal == jr.num_optimal == 32
    np.testing.assert_allclose(float(tr.obj), float(jr.obj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(numpy(tr.objs), np.asarray(jr.objs), rtol=0, atol=1e-10)
    np.testing.assert_allclose(numpy(tr.x), np.asarray(jr.x), rtol=0, atol=1e-8)
    # the lowest well, at x0 < 0 and x1 < 0, and all four reached
    assert float(tr.x[0]) < 0 and float(tr.x[1]) < 0
    wells = {(bool(a > 0), bool(b > 0)) for a, b in numpy(tr.batch.x)}
    assert len(wells) == 4


def test_multistart_without_an_optimal_lane():
    params = Params(iteration_limit=1)
    tr = multistart_solve(FourWells(), np.array([[1.9, 1.9], [-1.9, 0.3]]), params, device="cpu")
    assert not tr.success and tr.best_index is None and tr.num_optimal == 0
    assert tr.objs.shape == (2,)


@pytest.mark.parametrize("entry", ["mixed", "multistart"])
def test_entry_points_without_a_card_raise(entry, monkeypatch):
    """No fallback to the CPU: without ``device`` both take the card, and
    raise when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "mixed":
            MixedPrecisionSolver(tprob.Rosenbrock())
        else:
            multistart_solve(FourWells(), np.zeros((2, 2)))
    with pytest.raises(ValueError, match="f64 target"):
        MixedPrecisionSolver(tprob.Rosenbrock(), Params(precision="Single"), device="cpu")
