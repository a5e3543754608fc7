"""The port's LDL^T tier against the JAX kernels in interpret mode.

The plain versions of the CUDA kernels run the same algorithms as the
TPU kernels in f32, so the lower triangles of the packed factors agree to
rtol = atol = 1e-4; the inertia agrees exactly; and the port's f64 refined
solve reaches |Ax - b|_inf <= 1e-9.  The CUDA kernels themselves are
tested on a card by ``test_torch_cuda.py``.

Every helper also takes a (B, n, n) stack and acts on each lane alone, as
its JAX counterpart does under explicit batch dimensions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygradflow_tpu.linalg.ldlt import ldlt_factor as jax_ldlt_factor
from pygradflow_tpu.linalg.ldlt import ldlt_num_neg_eigvals as jax_num_neg
from pygradflow_tpu.linalg.ldlt import ldlt_solve as jax_ldlt_solve
from pygradflow_tpu.linalg.pallas_ldlt import pallas_ldlt_factor_f32
from pygradflow_tpu.linalg.pallas_ldlt_hbm import pallas_ldlt_factor_hbm
from pygradflow_tpu.linalg.two_level_ldlt import ldlt_factor_batched_panels as jax_batched_panels
from pygradflow_tpu.linalg.two_level_ldlt import ldlt_factor_residual as jax_residual
from pygradflow_torch.linalg import (
    PALLAS_HBM_MAX_N,
    PALLAS_MAX_N,
    factor_route,
    linear_solver,
)
from pygradflow_torch.linalg import ldlt_kernels as lk
from pygradflow_torch.linalg.ldlt import ldlt_factor, ldlt_num_neg_eigvals, ldlt_solve
from pygradflow_torch.linalg.two_level_ldlt import (
    guard_factor,
    ldlt_factor_batched_panels,
    ldlt_factor_residual,
)
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
    """Above the left-looking kernel's limit both a matrix and a stack take
    the two-level factor (``two_level_ldlt.ldlt_factor_two_level``), which
    was ROADMAP A8 and is ported now."""
    assert factor_route(PALLAS_HBM_MAX_N + 1) == "two_level"
    assert factor_route(PALLAS_HBM_MAX_N + 1, batched=True) == "two_level"


def test_ldlt_solve_takes_a_matrix_rhs():
    """A right-hand side with as many dimensions as the factor is (..., k, n),
    k systems per factor, as in JAX; before, the lane axis was broadcast
    against k and the answer was wrong without an error."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 3, 3))
    a = h @ h.transpose(0, 2, 1) + 3 * np.eye(3)
    b = rng.standard_normal((2, 2, 3))
    fact = ldlt_factor(tensor(a))
    x = numpy(ldlt_solve(fact, tensor(b)))
    ref = np.asarray(jax_ldlt_solve(jax_ldlt_factor(jnp.asarray(a)), jnp.asarray(b)))
    np.testing.assert_allclose(x, ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(x, np.linalg.solve(a, b.transpose(0, 2, 1)).transpose(0, 2, 1), atol=1e-12)
    # one factor, a (k, n) matrix of right-hand sides
    x0 = numpy(ldlt_solve(fact[0], tensor(b[0])))
    np.testing.assert_allclose(x0, np.linalg.solve(a[0], b[0].T).T, atol=1e-12)


def test_pallas_tier_solve_takes_iters():
    """``iters=0`` is the raw f32 back-solve (the Schur callers refine around
    it); the default three passes reach f64 accuracy, as in JAX."""
    rng = np.random.default_rng(7)
    a = saddle(rng, 50, 14)
    b = rng.standard_normal(64)
    lin = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)
    fact = lin.factor(tensor(a))
    raw = numpy(lin.solve(fact, tensor(b), iters=0))
    f32 = numpy(ldlt_solve(fact[0], tensor(b).to(torch.float32)).to(torch.float64))
    np.testing.assert_array_equal(raw, f32)
    refined = numpy(lin.solve(fact, tensor(b)))
    assert np.abs(a @ refined - b).max() <= RES_TOL < np.abs(a @ raw - b).max()


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


@pytest.mark.parametrize(
    "mat,error",
    [
        (torch.zeros((2, 4, 4), dtype=torch.float64), TypeError),
        (torch.zeros((4, 4), dtype=torch.float32), ValueError),
        (torch.zeros((2, 4, 5), dtype=torch.float32), ValueError),
        (torch.zeros((0, 4, 4), dtype=torch.float32), ValueError),
        (torch.zeros((2, 8, 8), dtype=torch.float32)[:, ::2, ::2], ValueError),
    ],
    ids=["float64", "one-matrix", "not-square", "empty", "not-contiguous"],
)
def test_batched_wrapper_rejects_bad_input(mat, error):
    with pytest.raises(error):
        lk.ldlt_factor_rl_batched(mat)


def _stack(shapes, seed=7):
    """A (B, n+m, n+m) stack of saddles with the same (n, m)."""
    rng = np.random.default_rng(seed)
    return np.stack([saddle(rng, n, m) for n, m in shapes])


@pytest.mark.parametrize("n,m", [(60, 20), (194, 130)], ids=["80", "324"])
def test_batched_plain_kernel_matches_jax_batched_kernel(n, m):
    """B2's plain version against the JAX batched route in interpret mode
    (``_call_batched``: vmap of B1), and bit for bit against B1's plain
    version on each instance."""
    a = _stack([(n, m)] * 3)
    a32 = tensor(a).to(torch.float32)
    ours = lk.ldlt_factor_rl_batched(a32)
    ref = np.asarray(pallas_ldlt_factor_f32(jnp.asarray(a), interpret=True))
    np.testing.assert_allclose(np.tril(numpy(ours)), np.tril(ref), rtol=F32_TOL, atol=F32_TOL)
    for i in range(a.shape[0]):
        assert torch.equal(ours[i], lk.ldlt_factor_rl_ref(a32[i].contiguous()))
    np.testing.assert_array_equal(numpy(ldlt_num_neg_eigvals(ours)), [m] * 3)


def test_batched_panels_match_jax():
    """The panel-batched route at n_pad = 512 (KKT 400)."""
    a = _stack([(300, 100)] * 2, seed=5)
    ours = ldlt_factor_batched_panels(tensor(a))
    ref = np.asarray(jax_batched_panels(jnp.asarray(a)))
    np.testing.assert_allclose(np.tril(numpy(ours)), np.tril(ref), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(numpy(ldlt_num_neg_eigvals(ours)), [100, 100])


@pytest.mark.parametrize(
    "n,route",
    [(80, "rl_batched"), (324, "rl_batched"), (384, "rl_batched"), (385, "panels"),
     (PALLAS_MAX_N, "panels"), (PALLAS_MAX_N + 4, "panels")],
)
def test_batched_factor_route(n, route):
    assert factor_route(n, batched=True) == route


def test_rank1_factor_solve_inertia_on_a_stack_match_jax():
    """``ldlt_factor``, ``ldlt_solve`` and ``ldlt_num_neg_eigvals`` act per
    lane of a stack, as the JAX ones do."""
    rng = np.random.default_rng(13)
    a = np.stack([saddle(rng, 20, m) for m in (4, 6, 8)][:1] * 3)
    a[1] = saddle(rng, 20, 4)
    a[2, 20:, 20:] = np.diag([-0.1, -0.1, 0.5, 0.5])  # two positive pivots among the last four
    b = rng.standard_normal((3, 24))
    ours = ldlt_factor(tensor(a))
    ref = np.asarray(jax_ldlt_factor(jnp.asarray(a)))
    np.testing.assert_allclose(np.tril(numpy(ours)), np.tril(ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(numpy(ldlt_num_neg_eigvals(ours)), np.asarray(jax_num_neg(jnp.asarray(ref))))
    x = numpy(ldlt_solve(ours, tensor(b)))
    np.testing.assert_allclose(x, np.asarray(jax_ldlt_solve(jnp.asarray(ref), jnp.asarray(b))), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", a, x), b, atol=1e-9)


def test_guard_poisons_only_the_broken_lane():
    """A 1e34 entry in one lane of a stack (as in
    ``test_pallas_ldlt.py::test_factor_guard_poisons_garbage``): the probe
    reads one residual per lane, at f32 rounding for the sound lanes and
    past the guard's 1e-2 for the broken one in both packages, and the
    guard leaves NaN in that lane alone."""
    a = tensor(_stack([(100, 28)] * 3)).to(torch.float32)
    packed = ldlt_factor(a)
    packed[1, 50, 10] = 1e34
    ours = numpy(ldlt_factor_residual(packed, a))
    ref = np.asarray(jax_residual(jnp.asarray(numpy(packed)), jnp.asarray(numpy(a))))
    assert ours.shape == ref.shape == (3,)
    np.testing.assert_array_equal(ours < 1e-6, [True, False, True])
    np.testing.assert_array_equal(ref < 1e-6, [True, False, True])
    assert ours[1] > 1e-2 and ref[1] > 1e-2
    guarded = guard_factor(packed, a)
    assert torch.isnan(guarded[1]).all()
    assert torch.isfinite(torch.tril(guarded[[0, 2]])).all()


def test_refine_solve_on_a_stack():
    rng = np.random.default_rng(17)
    a = _stack([(50, 14)] * 3, seed=17)
    b = rng.standard_normal((3, 64))
    packed = lk.ldlt_factor_rl_batched(tensor(a).to(torch.float32))
    x = numpy(lk.refine_solve(packed, tensor(a), tensor(b)))
    assert np.abs(np.einsum("bij,bj->bi", a, x) - b).max() <= RES_TOL


def test_linear_solver_tier_on_a_stack():
    """A zero pivot in one lane of a stack: that lane's factor is NaN after
    the guard, the others solve to 1e-9 with exact inertia, and CPU tensors
    launch nothing."""
    rng = np.random.default_rng(7)
    a = _stack([(60, 20)] * 3)
    a[2, 30, :] = 0.0
    a[2, :, 30] = 0.0
    b = rng.standard_normal((3, 80))
    before = dict(lk.LAUNCHES)
    lin = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)
    fact = lin.factor(tensor(a))
    x = numpy(lin.solve(fact, tensor(b)))
    assert np.abs(np.einsum("bij,bj->bi", a[:2], x[:2]) - b[:2]).max() <= RES_TOL
    assert np.isnan(x[2]).all()
    np.testing.assert_array_equal(numpy(lin.num_neg_eigvals(fact))[:2], [20, 20])
    assert lk.LAUNCHES == before
