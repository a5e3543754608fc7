"""Symmetric block-tridiagonal solvers (counterpart of
``pygradflow_tpu/linalg/block_tridiag.py``).

Optimal-control duals have this structure: with a block-diagonal
Hessian and stage-local constraints, the dual Schur complement
``S = -c I - J A^{-1} J^T`` is symmetric block tridiagonal with one
(q, q) block per stage.  A matrix is given by its bands: ``diag``
(..., M, q, q) and ``upper`` (..., M-1, q, q), the subdiagonal being
``upper[i]^T``.  Every function takes leading lane dimensions.

- ``btd_factor``/``btd_solve``: block Thomas, M sequential steps (a
  Python loop here); the reference the cyclic reduction is held to.
- ``bcr_factor``/``bcr_solve``: block cyclic reduction (Buzbee, Golub &
  Nielson 1970), log2(M) levels of batched (M/2, q, q) work, down to a
  dense root of ``base`` block rows.  With ``root_lin`` (the ``PallasLDLT``
  tier) the root goes to that tier when its size is a multiple of 128 (the
  kernel's panel), which is how the solve path reaches kernel B1'.

The levels are plain torch, as they were XLA ops in the JAX package.
"""

from typing import Any, NamedTuple

import torch

from .blocked_ldlt import ldlt_factor_blocked
from .ldlt import ldlt_factor, ldlt_solve


class BTDFactor(NamedTuple):
    facts: Any  # (..., M, q, q) packed LDL^T of the pivot blocks C_i
    upper: Any  # (..., M-1, q, q) super-diagonal blocks U_i


def _solve_mat(fact, rhs):
    """Solve C X = B for (..., q, k) right-hand sides with the packed
    factors (..., q, q)."""
    return ldlt_solve(fact, rhs.mT).mT


def btd_factor(diag, upper) -> BTDFactor:
    """Block Thomas: C_0 = D_0, C_i = D_i - U_{i-1}^T C_{i-1}^{-1} U_{i-1}."""
    facts = [ldlt_factor(diag[..., 0, :, :])]
    for i in range(1, diag.shape[-3]):
        u_prev = upper[..., i - 1, :, :]
        x = _solve_mat(facts[-1], u_prev)
        facts.append(ldlt_factor(diag[..., i, :, :] - u_prev.mT @ x))
    return BTDFactor(facts=torch.stack(facts, dim=-3), upper=upper)


def btd_solve(fact: BTDFactor, rhs):
    """Solve T x = rhs for rhs (..., M * q)."""
    facts, upper = fact
    m_blocks, q = facts.shape[-3], facts.shape[-1]
    r = rhs.reshape(rhs.shape[:-1] + (m_blocks, q))
    # forward sweep: z_i = r_i - U_{i-1}^T C_{i-1}^{-1} z_{i-1}
    z = [r[..., 0, :]]
    for i in range(1, m_blocks):
        w = ldlt_solve(facts[..., i - 1, :, :], z[-1])
        z.append(r[..., i, :] - (upper[..., i - 1, :, :].mT @ w[..., None])[..., 0])
    # backward sweep: x_i = C_i^{-1} (z_i - U_i x_{i+1})
    x = [ldlt_solve(facts[..., -1, :, :], z[-1])]
    for i in range(m_blocks - 2, -1, -1):
        v = z[i] - (upper[..., i, :, :] @ x[-1][..., None])[..., 0]
        x.append(ldlt_solve(facts[..., i, :, :], v))
    return torch.stack(x[::-1], dim=-2).reshape(rhs.shape)


def dense_to_btd(S, q):
    """The (diag, upper) bands of a dense (..., m, m) matrix that is block
    tridiagonal with (q, q) blocks; entries outside the band are ignored."""
    mb = S.shape[-1] // q
    sb = S.reshape(S.shape[:-2] + (mb, q, mb, q))
    diag = torch.diagonal(sb, dim1=-4, dim2=-2).movedim(-1, -3)
    upper = torch.diagonal(sb, offset=1, dim1=-4, dim2=-2).movedim(-1, -3)
    return diag, upper


class BCRLevel(NamedTuple):
    facts_odd: Any  # (..., H, q, q) packed LDL^T of the odd pivot blocks
    a_left: Any  # (..., H, q, q) U[2t-1]: couples even 2t to odd 2t-1 (0 at t=0)
    a_right: Any  # (..., H, q, q) U[2t]: couples even 2t to odd 2t+1
    b_right: Any  # (..., H, q, q) U[2t+1]: couples odd 2t+1 to even 2t+2 (0 at t=H-1)


class BCRFactor(NamedTuple):
    levels: tuple  # BCRLevel per level, coarsest last
    root_fact: Any  # factor of the dense root
    m_blocks: int  # block rows before the power-of-two padding
    q: int
    m_base: int  # block rows of the root
    root_kind: str  # "ldlt", or "lin" (the external tier)


BCR_BASE = 8
"""Block rows at which the reduction stops by default: the last levels cost
more than a small dense root (8 * 2 = 16 rows)."""

BCR_HYBRID_BASE = 256
"""Block rows at which the reduction stops when the root goes to the
``PallasLDLT`` tier: a few levels, then one dense root (512 rows at q = 2)
for kernel B1'."""


def _prepend_zero(x, dim):
    """``x`` with a zero block put first along ``dim``."""
    shape = list(x.shape)
    shape[dim] = 1
    return torch.cat([x.new_zeros(shape), x], dim=dim)


def _shift_down(x, dim):
    """Element t of ``dim`` becomes x[t-1], element 0 zero.  The JAX package
    rolls here and multiplies the wrapped element by a zero coupling block;
    a zero in its place keeps a non-finite wrapped value out of the
    result."""
    return _prepend_zero(x.narrow(dim, 0, x.shape[dim] - 1), dim)


def _btd_to_dense(d, u):
    """The dense (..., mb*q, mb*q) matrix of bands d (..., mb, q, q) and
    u (..., >= mb-1, q, q)."""
    mb, q = d.shape[-3], d.shape[-1]
    S = d.new_zeros(d.shape[:-3] + (mb, q, mb, q))
    torch.diagonal(S, dim1=-4, dim2=-2).copy_(d.movedim(-3, -1))
    if mb > 1:
        up = u[..., : mb - 1, :, :]
        torch.diagonal(S, offset=1, dim1=-4, dim2=-2).copy_(up.movedim(-3, -1))
        torch.diagonal(S, offset=-1, dim1=-4, dim2=-2).copy_(up.mT.movedim(-3, -1))
    return S.reshape(d.shape[:-3] + (mb * q, mb * q))


def bcr_factor(diag, upper, base: int = BCR_BASE, root_lin=None) -> BCRFactor:
    """Cyclic-reduction factorization.  The block count is padded to a power
    of two with decoupled -I blocks (negative definite, coupled to
    nothing).  ``base`` stops the reduction at that many block rows;
    ``root_lin`` factors the dense root when its size is a multiple of 128,
    otherwise the f64 LDL^T does (rank-1 up to 192 rows, blocked above)."""
    m_blocks, q = diag.shape[-3], diag.shape[-1]
    lead = diag.shape[:-3]
    mp = 1 << (m_blocks - 1).bit_length()
    zero = diag.new_zeros(lead + (1, q, q))
    if mp != m_blocks:
        eye = -torch.eye(q, dtype=diag.dtype, device=diag.device)
        diag = torch.cat([diag, eye.expand(lead + (mp - m_blocks, q, q))], dim=-3)
    # upper as (..., mp, q, q), upper[i] coupling (i, i+1), zero at the end
    up = torch.cat([upper, zero.expand(lead + (mp - upper.shape[-3], q, q))], dim=-3)

    levels = []
    d, u = diag, up
    m_cur = mp
    while m_cur > base:
        facts_odd = ldlt_factor(d[..., 1::2, :, :])  # (..., h, q, q)
        b_right = u[..., 1::2, :, :]  # U[2t+1]; the last is the zero pad
        a_left = _shift_down(b_right, -3)  # U[2t-1], zero at t=0
        a_right = u[..., 0::2, :, :]  # U[2t]
        levels.append(BCRLevel(facts_odd, a_left, a_right, b_right))

        # X_l[t] = F_{t-1}^{-1} A_left[t], zero at t=0
        x_left = _prepend_zero(
            _solve_mat(facts_odd[..., :-1, :, :], a_left[..., 1:, :, :]), -3
        )
        x_right = _solve_mat(facts_odd, a_right.mT)
        d = (
            d[..., 0::2, :, :]
            - torch.einsum("...tij,...tik->...tjk", a_left, x_left)
            - torch.einsum("...tij,...tkj->...tik", a_right, x_right.mT)
        )
        # U'_t = -A_right[t] F_t^{-1} B_right[t]
        u = -torch.einsum("...tij,...tjk->...tik", a_right, _solve_mat(facts_odd, b_right))
        m_cur //= 2

    root_dense = _btd_to_dense(d, u)
    nroot = m_cur * q
    if root_lin is not None and nroot % 128 == 0:
        root_fact, root_kind = root_lin.factor(root_dense), "lin"
    else:
        root_fact = ldlt_factor(root_dense) if nroot <= 192 else ldlt_factor_blocked(root_dense)
        root_kind = "ldlt"
    return BCRFactor(tuple(levels), root_fact, m_blocks, q, m_cur, root_kind)


def bcr_solve(fact: BCRFactor, rhs, root_solve=None):
    """Solve T x = rhs for rhs (..., M * q).  ``root_solve(root_fact, r)``
    solves the root when the factor was built with ``root_lin``."""
    m_blocks, q = fact.m_blocks, fact.q
    lead = rhs.shape[:-1]
    r = rhs.reshape(lead + (m_blocks, q))
    mp = 1 << (m_blocks - 1).bit_length()
    if mp != m_blocks:
        r = torch.cat([r, r.new_zeros(lead + (mp - m_blocks, q))], dim=-2)

    # down-sweep: reduce the right-hand side level by level, keeping the
    # odd parts
    odd_rhs = []
    for lev in fact.levels:
        b_odd = r[..., 1::2, :]
        odd_rhs.append(b_odd)
        f_inv_b = ldlt_solve(lev.facts_odd, b_odd)  # (..., h, q)
        r = (
            r[..., 0::2, :]
            - torch.einsum("...tij,...ti->...tj", lev.a_left, _shift_down(f_inv_b, -2))
            - torch.einsum("...tij,...tj->...ti", lev.a_right, f_inv_b)
        )

    # the dense root on the remaining m_base block rows
    if fact.root_kind == "lin":
        assert root_solve is not None, "an external root tier needs root_solve"
        x = root_solve(fact.root_fact, r.reshape(lead + (-1,)))
    else:
        x = ldlt_solve(fact.root_fact, r.reshape(lead + (-1,)))
    x = x.reshape(lead + (fact.m_base, q))

    # up-sweep: recover the odd blocks and interleave them with the even
    for lev, b_odd in zip(reversed(fact.levels), reversed(odd_rhs)):
        h = b_odd.shape[-2]
        # x[t+1], the right even neighbour of odd t (zero past the end)
        x_next = torch.cat([x[..., 1:, :], x.new_zeros(lead + (1, q))], dim=-2)
        rhs_odd = (
            b_odd
            - torch.einsum("...tij,...ti->...tj", lev.a_right, x)
            - torch.einsum("...tij,...tj->...ti", lev.b_right, x_next)
        )
        x_odd = ldlt_solve(lev.facts_odd, rhs_odd)
        x = torch.stack([x, x_odd], dim=-2).reshape(lead + (2 * h, q))

    return x[..., :m_blocks, :].reshape(lead + (m_blocks * q,))
