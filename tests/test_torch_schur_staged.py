"""The port's matrix-free staged Schur path against the JAX package: the
probe extraction, the anchors of the staged solves (f64 and through the
PallasLDLT tier, whose BCR root reaches B1's plain version), a
``BatchedSolver`` fleet lane by lane, and the two configuration errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch.eval import lane_fns, make_fns
from pygradflow_torch.iterate import aug_lag_deriv_x, aug_lag_deriv_xx, evaluate_iterate
from pygradflow_torch.linalg import ldlt_kernels as lk
from pygradflow_torch.parallel import BatchedSolver
from pygradflow_torch.runners.control import PendulumControlInterleaved as TInterleaved
from pygradflow_torch.step.schur_staged import _extract_stage_data
from pygradflow_tpu.eval import make_fns as j_make_fns
from pygradflow_tpu.iterate import evaluate_iterate as j_evaluate_iterate
from pygradflow_tpu.parallel import BatchedSolver as JBatchedSolver
from pygradflow_tpu.runners.control import PendulumControlInterleaved as JInterleaved
from pygradflow_tpu.step.schur_staged import _extract_stage_data as j_extract_stage_data

from .test_torch_batch import _check_lanes, _check_single
from .test_torch_schur import SCHUR, X_F64, X_MIXED, check_same_solve, solve_both
from .torch_parity import numpy, params_pair, tensor

MATRIX_FREE = dict(schur_dual_block_size=2, matrix_free=True)
STAGED = dict(SCHUR, **MATRIX_FREE)


def test_extracted_stage_data_matches_jax():
    """N = 13: the probed Hessian blocks and Jacobian bands, to 1e-12; on a
    stack of lanes (the probe vmap nested in the lane vmap) each lane equals
    its single extraction."""
    N = 13
    jp, tp = params_pair(**STAGED)
    rng = np.random.default_rng(0)
    x = JInterleaved(N=N).x0_trajectory() + 0.1 * rng.standard_normal(3 * (N + 1))
    y = rng.standard_normal(2 * (N + 1))
    fns = make_fns(TInterleaved(N=N), tp)
    jfns = j_make_fns(JInterleaved(N=N), jp)
    ours = _extract_stage_data(fns, evaluate_iterate(fns, tensor(x), tensor(y)), 3, 2)
    ref = j_extract_stage_data(jfns, j_evaluate_iterate(jfns, jnp.asarray(x), jnp.asarray(y)), 3, 2)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(numpy(o), np.asarray(r), rtol=1e-12, atol=1e-12)

    xs = np.stack([x, x + 0.05 * rng.standard_normal(x.shape)])
    ys = np.stack([y, -y])
    lfns = lane_fns(fns)
    stacked = _extract_stage_data(lfns, evaluate_iterate(lfns, tensor(xs), tensor(ys)), 3, 2)
    for lane in range(2):
        single = _extract_stage_data(fns, evaluate_iterate(fns, tensor(xs[lane]), tensor(ys[lane])), 3, 2)
        for s, o in zip(stacked, single):
            torch.testing.assert_close(s[lane], o, rtol=1e-13, atol=1e-13)


def test_matrix_free_iterate_holds_no_jacobian():
    _, tp = params_pair(**STAGED)
    fns = make_fns(TInterleaved(N=8), tp)
    x = tensor(TInterleaved(N=8).x0_trajectory())
    assert tuple(evaluate_iterate(fns, x, torch.zeros(18, dtype=x.dtype)).cons_jac.shape) == (0, 27)
    lfns = lane_fns(fns)
    it = evaluate_iterate(lfns, x.expand(3, 27), torch.zeros((3, 18), dtype=x.dtype))
    assert tuple(it.cons_jac.shape) == (3, 0, 27)
    # the iterate itself routes J^T products to the vjp, and says so
    # when no fns came with it
    torch.testing.assert_close(aug_lag_deriv_x(it, 0.5, lfns), it.obj_grad + lfns.cons_vjp(it.x, 0.5 * it.cons))
    with pytest.raises(ValueError, match="needs fns"):
        aug_lag_deriv_x(it, 0.5)
    # nor can it give the J^T J term of the dense Hessian
    with pytest.raises(ValueError, match="holds no Jacobian"):
        aug_lag_deriv_xx(lfns, it, torch.full((3,), 0.5, dtype=x.dtype))


@pytest.mark.parametrize(
    "N,kwargs,counts,tol",
    [
        (24, dict(), (15, 15), X_F64),
        (40, dict(), (16, 14), X_F64),
        (40, dict(linear_solver_type="PallasLDLT"), (16, 14), X_MIXED),
        (256, dict(), (18, 17), X_F64),
        (256, dict(linear_solver_type="PallasLDLT"), (18, 17), X_MIXED),
        (1024, dict(), (18, 17), X_F64),
    ],
    ids=["24", "40", "40-pallas", "256", "256-pallas", "1024"],
)
def test_staged_pendulum_matches_jax(N, kwargs, counts, tol):
    """The staged anchors.  With PallasLDLT the BCR root is 64 * 2 = 128
    rows at N = 40 and 256 * 2 = 512 at N = 256, a multiple of 128, so it
    goes to the tier (B1's plain version here)."""
    check_same_solve(*solve_both(N, **MATRIX_FREE, **kwargs), counts, tol)


@pytest.mark.parametrize("kwargs", [dict(), dict(linear_solver_type="PallasLDLT")], ids=["f64", "pallas"])
def test_staged_fleet_matches_jax_and_single(kwargs):
    """``BatchedSolver`` at N = 12, B = 4 from ``base + 0.02 N(0, 1)``
    (``default_rng(3)``): every lane equals the JAX lane and the port's own
    single ``Solver``; the PallasLDLT root (16 * 2 = 32 rows) is not a
    multiple of 128, so it takes the f64 factor."""
    rng = np.random.default_rng(3)
    base = JInterleaved(N=12).x0_trajectory()
    x0s = np.stack([base + 0.02 * rng.standard_normal(base.shape) for _ in range(4)])
    jp, tp = params_pair(**STAGED, **kwargs)
    jr = JBatchedSolver(JInterleaved(N=12), jp).solve(x0s)
    before = dict(lk.LAUNCHES)
    tr = BatchedSolver(TInterleaved(N=12), tp, device="cpu").solve(x0s)
    assert lk.LAUNCHES == before
    _check_lanes(tr, jr)
    assert numpy(tr.iterations).tolist() == [17] * 4
    for lane in range(4):
        single = pygradflow_torch.Solver(TInterleaved(N=12), tp, device="cpu").solve(tensor(x0s[lane]))
        _check_single(tr, lane, single)


def test_matrix_free_requires_schur():
    jp, tp = params_pair(**dict(STAGED, step_solver_type="Symmetric"))
    with pytest.raises(ValueError, match="matrix_free requires"):
        pygradflow_tpu.Solver(JInterleaved(N=8), jp)
    with pytest.raises(ValueError, match="matrix_free requires"):
        pygradflow_torch.Solver(TInterleaved(N=8), tp, device="cpu")


def test_matrix_free_rejects_globalized():
    jp, tp = params_pair(**dict(STAGED, newton_type="Globalized"))
    with pytest.raises(ValueError, match="Globalized"):
        pygradflow_tpu.Solver(JInterleaved(N=8), jp)
    with pytest.raises(ValueError, match="Globalized"):
        pygradflow_torch.Solver(TInterleaved(N=8), tp, device="cpu")


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(schur_block_size=None), "requires params.schur_block_size"),
        (dict(schur_dual_block_size=None), "requires params.schur_dual_block_size"),
        (dict(schur_block_size=2), "one dual block of size 2 per stage of size 2"),
    ],
    ids=["no-block-size", "no-dual-block-size", "not-staged"],
)
def test_schur_configuration_errors(kwargs, match):
    """The JAX package asserts these; the port raises ``ValueError``, since
    they check the user's configuration."""
    _, tp = params_pair(**dict(STAGED, **kwargs))
    with pytest.raises(ValueError, match=match):
        pygradflow_torch.Solver(TInterleaved(N=8), tp, device="cpu")
