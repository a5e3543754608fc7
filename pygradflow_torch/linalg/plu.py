"""Dense LU with partial pivoting (counterpart of ``pygradflow_tpu/linalg/plu.py``).

The default tier of ``Params()``: plain torch, as the JAX package computes
it outside any kernel.  Every function takes one matrix (n, n) or a stack
(..., n, n) and acts on each matrix alone.

Right-looking rank-1 form with the reference's arithmetic: the pivot of
column k is the first entry of largest magnitude on or below the diagonal
(``argmax`` takes the first maximum), rows are swapped through a
permutation gather, and a zero pivot poisons the factor with NaN so that the
step layer rejects the step.  Solves of n <= ``UNROLL_MAX_N`` use the same
column sweeps as the reference; larger ones use triangular solves, as the
reference uses XLA's there.
"""

from typing import Any, NamedTuple

import torch

UNROLL_MAX_N = 16


class PLUFactorization(NamedTuple):
    lu: Any  # packed: strict lower = L (unit diagonal), upper = U
    perm: Any  # row permutation: row i of PA is row perm[i] of A


def plu_factor(mat) -> PLUFactorization:
    n = mat.shape[-1]
    idx = torch.arange(n, device=mat.device)
    a = mat
    perm = idx.expand(mat.shape[:-1])
    for k in range(n):
        col = torch.where(idx >= k, torch.abs(a[..., :, k]), float("-inf"))
        p = torch.argmax(col, dim=-1, keepdim=True)
        # swap rows k and p: sigma maps k -> p, p -> k, others to themselves
        sigma = torch.where(idx == k, p, torch.where(idx == p, k, idx))
        a = torch.gather(a, -2, sigma[..., :, None].expand(a.shape))
        perm = torch.gather(perm, -1, sigma)

        piv = a[..., k, k]
        inv = torch.where(piv != 0.0, 1.0 / piv, float("nan"))
        below = idx > k
        l_col = torch.where(below, a[..., :, k] * inv[..., None], 0.0)
        u_row = torch.where(idx >= k + 1, a[..., k, :], 0.0)
        a = a - l_col[..., :, None] * u_row[..., None, :]
        a[..., :, k] = torch.where(below, l_col, a[..., :, k])
    return PLUFactorization(lu=a, perm=perm)


def _unpack(fact: PLUFactorization):
    lu = fact.lu
    n = lu.shape[-1]
    lower = torch.tril(lu, diagonal=-1) + torch.eye(n, dtype=lu.dtype, device=lu.device)
    return lower, torch.triu(lu)


def _fwd_sub_unit(L, b):
    """Solve L z = b with unit-lower L by column sweep."""
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    z = b
    for k in range(n):
        z = z - torch.where(idx > k, L[..., :, k] * z[..., k, None], 0.0)
    return z


def _back_sub(U, b):
    """Solve U x = b with upper-triangular U by column sweep."""
    n = U.shape[-1]
    idx = torch.arange(n, device=U.device)
    x = b.clone()
    for k in range(n - 1, -1, -1):
        xk = x[..., k] / U[..., k, k]
        x[..., k] = xk
        x = x - torch.where(idx < k, U[..., :, k] * xk[..., None], 0.0)
    return x


def _back_sub_unit_T(L, b):
    """Solve L^T x = b with unit-lower L."""
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    x = b
    for k in range(n - 1, -1, -1):
        x = x - torch.where(idx < k, L[..., k, :] * x[..., k, None], 0.0)
    return x


def _fwd_sub_T(U, b):
    """Solve U^T z = b with upper-triangular U."""
    n = U.shape[-1]
    idx = torch.arange(n, device=U.device)
    z = b.clone()
    for k in range(n):
        zk = z[..., k] / U[..., k, k]
        z[..., k] = zk
        z = z - torch.where(idx > k, U[..., k, :] * zk[..., None], 0.0)
    return z


def plu_solve(fact: PLUFactorization, rhs):
    """Solve A x = rhs, ``rhs`` (..., n), from the packed factorization."""
    lower, upper = _unpack(fact)
    n = lower.shape[-1]
    b = torch.gather(rhs, -1, fact.perm)
    if n <= UNROLL_MAX_N:
        return _back_sub(upper, _fwd_sub_unit(lower, b))
    z = torch.linalg.solve_triangular(lower, b[..., None], upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(upper, z, upper=True)[..., 0]


def plu_solve_trans(fact: PLUFactorization, rhs):
    """Solve A^T x = rhs: U^T L^T P x = rhs."""
    lower, upper = _unpack(fact)
    n = lower.shape[-1]
    if n <= UNROLL_MAX_N:
        y = _back_sub_unit_T(lower, _fwd_sub_T(upper, rhs))
    else:
        z = torch.linalg.solve_triangular(upper.mT, rhs[..., None], upper=False)
        y = torch.linalg.solve_triangular(lower.mT, z, upper=True, unitriangular=True)[..., 0]
    # x = P^T y: scatter back through the permutation
    return torch.zeros_like(y).scatter(-1, fact.perm, y)
