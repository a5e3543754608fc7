"""The port's Schur-tier linear algebra and dense Schur solves against the
JAX package.

- factors: the blocked f64 LDL^T, the LDLT and Cholesky tiers, the
  two-level f32 factor (single and a stack), with JAX's Pallas kernel in
  interpret mode;
- block tridiagonal: block Thomas and cyclic reduction on the matrices of
  ``tests/test_schur.py``, and the hybrid root through the PallasLDLT tier;
- solves: the dense dual Schur paths on ``PendulumControlInterleaved``
  (f64, block tridiagonal, PallasLDLT, both), each with JAX's status,
  iteration and accepted-step counts and evaluation counts, x within 1e-8
  on the f64 paths and 1e-6 on the mixed ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch.linalg import linear_solver
from pygradflow_torch.linalg import ldlt_kernels as lk
from pygradflow_torch.linalg.blocked_ldlt import ldlt_factor_blocked
from pygradflow_torch.linalg.block_tridiag import bcr_factor, bcr_solve, btd_factor, btd_solve, dense_to_btd
from pygradflow_torch.linalg.ldlt import ldlt_num_neg_eigvals
from pygradflow_torch.linalg.two_level_ldlt import ldlt_factor_two_level
from pygradflow_torch.params import LinearSolverType
from pygradflow_torch.runners.control import PendulumControlInterleaved as TInterleaved
from pygradflow_tpu.linalg import linear_solver as j_linear_solver
from pygradflow_tpu.linalg import block_tridiag as jbt
from pygradflow_tpu.linalg.blocked_ldlt import ldlt_factor_blocked as j_blocked
from pygradflow_tpu.linalg.two_level_ldlt import ldlt_factor_two_level as j_two_level
from pygradflow_tpu.runners.control import PendulumControlInterleaved as JInterleaved

from .torch_parity import numpy, params_pair, saddle, tensor

F64_TOL = 1e-12  # the same f64 algorithm, sums in another order
F32_TOL = 2e-3  # packed f32 factors (tests/test_pallas_ldlt.py's bound)
X_F64 = 1e-8  # solutions, f64 paths
X_MIXED = 1e-6  # solutions, paths through the f32 factor plus refinement
SCHUR = dict(step_solver_type="Schur", schur_block_size=3, iteration_limit=3000, validate_input=False)


@pytest.mark.parametrize("n", [100, 192, 300])
def test_blocked_ldlt_matches_jax(n):
    """n = 100 takes the rank-1 factor (one panel), 192 two panels with
    padding, 300 three."""
    a = saddle(np.random.default_rng(n), n - n // 3, n // 3)
    ours = numpy(ldlt_factor_blocked(tensor(a)))
    ref = np.asarray(j_blocked(jnp.asarray(a)))
    np.testing.assert_allclose(np.tril(ours), np.tril(ref), rtol=F64_TOL, atol=F64_TOL)
    assert int(ldlt_num_neg_eigvals(torch.tensor(ours))) == n // 3


@pytest.mark.parametrize("n", [100, 300], ids=["rank1", "blocked"])
def test_ldlt_tier_matches_jax(n):
    rng = np.random.default_rng(3)
    a = saddle(rng, n - 40, 40)
    b = rng.standard_normal(n)
    lin, jlin = linear_solver(LinearSolverType.LDLT), j_linear_solver(pygradflow_tpu.LinearSolverType.LDLT)
    fact, jfact = lin.factor(tensor(a)), jlin.factor(jnp.asarray(a))
    x = numpy(lin.solve(fact, tensor(b)))
    np.testing.assert_allclose(x, np.asarray(jlin.solve(jfact, jnp.asarray(b))), rtol=1e-10, atol=1e-12)
    assert np.abs(a @ x - b).max() <= 1e-9
    assert int(lin.num_neg_eigvals(fact)) == int(jlin.num_neg_eigvals(jfact)) == 40


def test_cholesky_tier_matches_jax():
    """A positive definite matrix solves as JAX's ``cho_solve``; one that is
    not gets a NaN factor in both packages, and in a stack only its lane."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((30, 30))
    spd = h @ h.T + 30 * np.eye(30)
    indef = saddle(rng, 20, 10)
    b = rng.standard_normal(30)
    lin, jlin = linear_solver(LinearSolverType.Cholesky), j_linear_solver(pygradflow_tpu.LinearSolverType.Cholesky)
    x = numpy(lin.solve(lin.factor(tensor(spd)), tensor(b)))
    np.testing.assert_allclose(x, np.asarray(jlin.solve(jlin.factor(jnp.asarray(spd)), jnp.asarray(b))), rtol=1e-10)
    assert np.abs(spd @ x - b).max() <= 1e-10

    jfact = jlin.factor(jnp.asarray(indef))  # (upper factor, lower=False)
    assert np.isnan(np.asarray(jfact[0])[np.triu_indices(30)]).all()
    assert np.isnan(np.asarray(jlin.solve(jfact, jnp.asarray(b)))).all()
    assert torch.isnan(lin.factor(tensor(indef))).all()
    assert torch.isnan(lin.solve(lin.factor(tensor(indef)), tensor(b))).all()

    fact = lin.factor(tensor(np.stack([spd, indef, spd])))
    assert torch.isnan(fact[1]).all() and torch.isfinite(fact[[0, 2]]).all()
    assert numpy(lin.num_neg_eigvals(fact)).tolist() == [0, 0, 0]


@pytest.mark.parametrize("batch", [None, 2], ids=["single", "stack"])
def test_two_level_matches_jax(batch):
    """n = 320 at super_block = 128: three super-blocks, padded to 384.  The
    diagonal blocks take B1's plain version (one matrix) or B2's (a stack),
    as JAX routes them."""
    rng = np.random.default_rng(7)
    shape = (1 if batch is None else batch,)
    a = np.stack([saddle(rng, 240, 80) for _ in range(shape[0])])
    if batch is None:
        a = a[0]
    before = dict(lk.LAUNCHES)
    ours = ldlt_factor_two_level(tensor(a), super_block=128)
    ref = np.asarray(j_two_level(jnp.asarray(a), super_block=128, interpret=True))
    assert lk.LAUNCHES == before  # CPU tensors take the plain versions
    np.testing.assert_allclose(np.tril(numpy(ours)), np.tril(ref), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(
        numpy(ldlt_num_neg_eigvals(ours)), np.sum(np.diagonal(ref, axis1=-2, axis2=-1) < 0, axis=-1)
    )
    b = rng.standard_normal(a.shape[:-1])
    x = numpy(lk.refine_solve(ours, tensor(a), tensor(b)))
    assert np.abs(np.einsum("...ij,...j->...i", a, x) - b).max() <= 1e-8


@pytest.mark.parametrize("lead", [(), (2,)], ids=["single", "stack"])
def test_two_level_default_super_block(monkeypatch, lead):
    """n = 2050 (the dual Schur complement at N = 1024) splits into two
    1025-wide diagonal blocks, as in JAX, not 3 x 1024: the diagonal factor
    sees exactly those (a stand-in factor records them)."""
    from pygradflow_torch.linalg import two_level_ldlt

    seen = []

    def record(block):
        seen.append(tuple(block.shape))
        return torch.eye(block.shape[-1]).expand(block.shape).clone()

    monkeypatch.setattr(two_level_ldlt, "_diag_block_factor", record)
    two_level_ldlt.ldlt_factor_two_level(torch.eye(2050, dtype=torch.float64).expand(lead + (2050, 2050)))
    assert seen == [lead + (1025, 1025)] * 2


def _btd_matrix(rng, M, q):
    """The negative definite block-tridiagonal matrix of ``tests/test_schur.py``."""
    m = M * q
    S = np.zeros((m, m))
    for i in range(M):
        B = rng.standard_normal((q, q))
        S[i * q : (i + 1) * q, i * q : (i + 1) * q] = -(B @ B.T + 5 * np.eye(q))
    for i in range(M - 1):
        U = 0.3 * rng.standard_normal((q, q))
        S[i * q : (i + 1) * q, (i + 1) * q : (i + 2) * q] = U
        S[(i + 1) * q : (i + 2) * q, i * q : (i + 1) * q] = U.T
    return S


@pytest.mark.parametrize("M,q", [(5, 2), (37, 2), (21, 3)])
def test_btd_and_bcr_match_jax(M, q):
    rng = np.random.default_rng(11)
    S = _btd_matrix(rng, M, q)
    rhs = rng.standard_normal(M * q)
    exact = np.linalg.solve(S, rhs)
    bands = dense_to_btd(tensor(S), q)
    ports = {"btd": (btd_factor, btd_solve), "bcr": (bcr_factor, bcr_solve)}
    for name, (factor, solve) in ports.items():
        ours = numpy(solve(factor(*bands), tensor(rhs)))
        jfactor, jsolve = getattr(jbt, f"{name}_factor"), getattr(jbt, f"{name}_solve")
        ref = np.asarray(
            jax.jit(lambda S_, r_: jsolve(jfactor(*jbt.dense_to_btd(S_, q)), r_))(jnp.asarray(S), jnp.asarray(rhs))
        )
        np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(ours, exact, rtol=1e-9, atol=1e-11)
    jlevels = len(jax.eval_shape(lambda S_: jbt.bcr_factor(*jbt.dense_to_btd(S_, q)), jnp.asarray(S)).levels)
    assert len(bcr_factor(*bands).levels) == jlevels


def test_bcr_on_a_stack_equals_each_lane():
    """Every BCR operation takes a leading lane axis; lanes do not mix."""
    rng = np.random.default_rng(13)
    mats = [_btd_matrix(rng, 37, 2) for _ in range(3)]
    rhs = rng.standard_normal((3, 74))
    diag, upper = dense_to_btd(tensor(np.stack(mats)), 2)
    x = numpy(bcr_solve(bcr_factor(diag, upper), tensor(rhs)))
    for i in range(3):
        np.testing.assert_allclose(x[i], np.linalg.solve(mats[i], rhs[i]), rtol=1e-9, atol=1e-11)


def test_bcr_hybrid_root_through_pallas_tier():
    """mb = 128 blocks, base = 64: one level, a dense root of 128 rows on
    the PallasLDLT tier (the plain B1 here, the interpret-mode kernel in
    JAX), against JAX's and against block Thomas."""
    rng = np.random.default_rng(5)
    mb, q = 128, 2
    diag = rng.standard_normal((mb, q, q))
    diag = -(diag @ diag.transpose(0, 2, 1)) - 2.0 * np.eye(q)
    upper = 0.1 * rng.standard_normal((mb - 1, q, q))
    rhs = rng.standard_normal(mb * q)

    lin = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)
    fact = bcr_factor(tensor(diag), tensor(upper), base=64, root_lin=lin)
    assert (fact.root_kind, fact.m_base, len(fact.levels)) == ("lin", 64, 1)
    ours = numpy(bcr_solve(fact, tensor(rhs), root_solve=lambda f, b: lin.solve(f, b)))

    jlin = j_linear_solver(pygradflow_tpu.LinearSolverType.PallasLDLT, symmetric=True)

    @jax.jit
    def jax_solve(d_, u_, r_):
        jfact = jbt.bcr_factor(d_, u_, base=64, root_lin=jlin)
        return jbt.bcr_solve(jfact, r_, root_solve=lambda f, b: jlin.solve(f, b))

    ref = np.asarray(jax_solve(jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(rhs)))
    thomas = numpy(btd_solve(btd_factor(tensor(diag), tensor(upper)), tensor(rhs)))
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ours, thomas, rtol=1e-9, atol=1e-12)


def solve_both(N, **kwargs):
    """The interleaved pendulum at horizon N from ``x0_trajectory()`` in both
    packages."""
    jp, tp = params_pair(**SCHUR, **kwargs)
    x0 = JInterleaved(N=N).x0_trajectory()
    jr = pygradflow_tpu.Solver(JInterleaved(N=N), jp).solve(x0)
    tr = pygradflow_torch.Solver(TInterleaved(N=N), tp, device="cpu").solve(tensor(x0))
    return jr, tr


def check_same_solve(jr, tr, counts, tol):
    assert jr.status == pygradflow_tpu.SolverStatus.Optimal
    assert tr.status.name == jr.status.name
    assert (jr.iterations, jr.num_accepted_steps) == counts
    assert (tr.iterations, tr.num_accepted_steps) == counts
    np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=tol)
    np.testing.assert_allclose(numpy(tr.y), jr.y, rtol=0, atol=tol)
    assert {c.name(): n for c, n in tr.num_evals.items()} == {
        c.name(): n for c, n in jr.num_evals.items()
    }


@pytest.mark.parametrize(
    "N,kwargs,counts,tol",
    [
        (16, dict(), (30, 15), X_F64),
        (16, dict(schur_dual_block_size=2), (30, 15), X_F64),
        (16, dict(linear_solver_type="PallasLDLT"), (30, 15), X_MIXED),
        (16, dict(schur_dual_block_size=2, linear_solver_type="PallasLDLT"), (30, 15), X_MIXED),
        (256, dict(), (18, 17), X_F64),
    ],
    ids=["dense", "bcr", "pallas-dense", "bcr-pallas", "dense-256"],
)
def test_schur_pendulum_matches_jax(N, kwargs, counts, tol):
    """The anchors of the dense Schur paths; at N = 256 the dual Schur
    complement (514 x 514) takes the blocked f64 factor."""
    check_same_solve(*solve_both(N, **kwargs), counts, tol)


def test_pallas_dense_dual_launches_nothing_on_cpu():
    """The mixed dense dual path on CPU tensors reaches the plain B1 only."""
    before = dict(lk.LAUNCHES)
    _, tp = params_pair(**SCHUR, linear_solver_type="PallasLDLT")
    res = pygradflow_torch.Solver(TInterleaved(N=4), tp, device="cpu").solve(tensor(TInterleaved(N=4).x0_trajectory()))
    assert res.status == pygradflow_torch.SolverStatus.Optimal
    assert lk.LAUNCHES == before
