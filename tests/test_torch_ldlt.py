"""The port's LDL^T tier against the JAX kernels in interpret mode.

The plain versions of the two CUDA kernels run the same algorithms as the
TPU kernels in f32, so the lower triangles of the packed factors agree to
rtol = atol = 1e-4; the inertia agrees exactly; and the port's f64 refined
solve reaches |Ax - b|_inf <= 1e-9.  The CUDA kernels themselves are
tested on a card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygradflow_tpu.linalg.ldlt import ldlt_factor as jax_ldlt_factor
from pygradflow_tpu.linalg.ldlt import ldlt_solve as jax_ldlt_solve
from pygradflow_tpu.linalg.pallas_ldlt import pallas_ldlt_factor_f32
from pygradflow_tpu.linalg.pallas_ldlt_hbm import pallas_ldlt_factor_hbm
from pygradflow_torch.linalg import (
    PALLAS_HBM_MAX_N,
    PALLAS_MAX_N,
    factor_route,
    linear_solver,
)
from pygradflow_torch.linalg import ldlt_kernels as lk
from pygradflow_torch.linalg.ldlt import ldlt_factor, ldlt_num_neg_eigvals, ldlt_solve
from pygradflow_torch.linalg.two_level_ldlt import guard_factor
from pygradflow_torch.params import LinearSolverType

from .torch_parity import numpy, saddle, tensor

F32_TOL = 1e-4  # the same algorithm in f32, sums in another order
RES_TOL = 1e-9


def _jax_rl(a):
    return np.asarray(pallas_ldlt_factor_f32(jnp.asarray(a), interpret=True))


def _jax_ll(a):
    return np.asarray(pallas_ldlt_factor_hbm(jnp.asarray(a), block=64, interpret=True))


CASES = [
    # (port's plain kernel, JAX kernel, saddle shape): no padding, padding
    (lk.ldlt_factor_rl_ref, _jax_rl, (96, 32)),
    (lk.ldlt_factor_rl_ref, _jax_rl, (100, 50)),
    (lk.ldlt_factor_ll_ref, _jax_ll, (200, 56)),
]


@pytest.mark.parametrize("plain,jax_kernel,shape", CASES, ids=["rl-128", "rl-150-padded", "ll-256"])
def test_plain_kernel_matches_jax_kernel(plain, jax_kernel, shape):
    rng = np.random.default_rng(7)
    n, m = shape
    a = saddle(rng, n, m)
    ours = numpy(plain(tensor(a).to(torch.float32)))
    ref = jax_kernel(a)
    np.testing.assert_allclose(np.tril(ours), np.tril(ref), rtol=F32_TOL, atol=F32_TOL)
    assert int(ldlt_num_neg_eigvals(torch.tensor(ours))) == m

    b = rng.standard_normal(n + m)
    x = numpy(lk.refine_solve(torch.tensor(ours), tensor(a), tensor(b)))
    assert np.abs(a @ x - b).max() <= RES_TOL


@pytest.mark.parametrize("plain", [lk.ldlt_factor_rl_ref, lk.ldlt_factor_ll_ref])
def test_zero_pivot_gives_nan(plain):
    rng = np.random.default_rng(3)
    a = saddle(rng, 150, 50)
    k = 140  # inside the second 128-wide and the third 64-wide panel
    a[k, :] = 0.0
    a[:, k] = 0.0
    a32 = tensor(a).to(torch.float32)
    packed = plain(a32)
    assert torch.isnan(torch.diagonal(packed)[k:]).any()
    assert torch.isfinite(torch.tril(packed)[:k, :k]).all()
    assert torch.isnan(guard_factor(packed, a32)).all()


def test_guard_factor_cases():
    """The three cases of ``test_pallas_ldlt.py::test_factor_guard_poisons_garbage``:
    a genuine factor passes, finite garbage is poisoned, NaN stays poison."""
    a = tensor(saddle(np.random.default_rng(7), 100, 28)).to(torch.float32)
    packed = ldlt_factor(a)

    assert torch.isfinite(torch.tril(guard_factor(packed, a))).all()

    garbage = packed.clone()
    garbage[50, 10] = 1e34
    assert torch.isnan(guard_factor(garbage, a)).all()

    poisoned = packed.clone()
    poisoned[3, 3] = float("nan")
    assert not torch.isfinite(guard_factor(poisoned, a)).all()


def test_rank1_factor_and_solve_match_jax():
    rng = np.random.default_rng(11)
    a = saddle(rng, 40, 12)
    b = rng.standard_normal(52)
    ours = ldlt_factor(tensor(a))
    ref = np.asarray(jax_ldlt_factor(jnp.asarray(a)))
    np.testing.assert_allclose(np.tril(numpy(ours)), np.tril(ref), rtol=1e-12, atol=1e-12)
    x = numpy(ldlt_solve(ours, tensor(b)))
    np.testing.assert_allclose(x, np.asarray(jax_ldlt_solve(jnp.asarray(ref), jnp.asarray(b))), rtol=1e-10, atol=1e-12)
    assert int(ldlt_num_neg_eigvals(ours)) == 12


@pytest.mark.parametrize(
    "n,route",
    [(644, "rl"), (PALLAS_MAX_N, "rl"), (PALLAS_MAX_N + 4, "ll"), (PALLAS_HBM_MAX_N, "ll")],
)
def test_factor_route(n, route):
    assert factor_route(n) == route


def test_factor_route_above_hbm_limit_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        factor_route(PALLAS_HBM_MAX_N + 1)


def test_linear_solver_tier():
    """Factor, refined solve and inertia through the factory, as
    ``test_pallas_ldlt.py::test_pallas_linear_solver_tier`` does; CPU
    tensors take the plain versions and launch nothing."""
    rng = np.random.default_rng(7)
    a = saddle(rng, 50, 14)
    b = rng.standard_normal(64)
    before = dict(lk.LAUNCHES)
    lin = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)
    fact = lin.factor(tensor(a))
    x = numpy(lin.solve(fact, tensor(b)))
    np.testing.assert_allclose(a @ x, b, atol=1e-8)
    assert int(lin.num_neg_eigvals(fact)) == 14
    assert lk.LAUNCHES == before


@pytest.mark.parametrize(
    "mat,error",
    [
        (torch.zeros((4, 4), dtype=torch.float64), TypeError),
        (torch.zeros((4, 5), dtype=torch.float32), ValueError),
        (torch.zeros((8, 8), dtype=torch.float32)[::2, ::2], ValueError),
    ],
    ids=["float64", "not-square", "not-contiguous"],
)
@pytest.mark.parametrize("wrapper", [lk.ldlt_factor_rl, lk.ldlt_factor_ll])
def test_wrapper_rejects_bad_input(wrapper, mat, error):
    with pytest.raises(error):
        wrapper(mat)
