"""Dense LDL^T: the plain rank-1 factor, the packed-factor solve and the
inertia count (counterpart of ``pygradflow_tpu/linalg/ldlt.py``).

Unpivoted: the saddle systems solved here are quasi-definite after the
``+ lambda I`` primal shift, for which the unpivoted factorization exists.
A zero pivot poisons the factor with NaN; the step layer turns that into a
rejected step with doubled lambda.
"""

import torch


def ldlt_factor(mat):
    """Packed factor of (..., n, n) by n rank-1 Schur updates: strict lower
    triangle holds L (unit diagonal implied), the diagonal holds D."""
    a = mat.clone()
    n = a.shape[-1]
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    for k in range(n):
        d = a[..., k, k]
        inv = torch.where(d != 0.0, 1.0 / d, nan)
        col = a[..., k + 1 :, k] * inv[..., None]
        a[..., k + 1 :, k + 1 :] -= d[..., None, None] * col[..., :, None] * col[..., None, :]
        a[..., k + 1 :, k] = col
    return a


def ldlt_solve(fact, rhs):
    """Solve ``L D L^T x = rhs`` from the packed factor (..., n, n).

    ``rhs`` is a vector (..., n), or, when it has as many dimensions as
    ``fact``, a matrix (..., k, n) of k right-hand sides: the system
    dimension is last either way, as in the JAX package.  The triangular
    solves stay library calls, as they were XLA ops outside any kernel."""
    n = fact.shape[-1]
    lower = torch.tril(fact, diagonal=-1) + torch.eye(n, dtype=fact.dtype, device=fact.device)
    d = torch.diagonal(fact, dim1=-2, dim2=-1)
    vector = rhs.ndim == fact.ndim - 1
    b = rhs[..., None] if vector else rhs.mT  # (..., n, k)
    z = torch.linalg.solve_triangular(lower, b, upper=False, unitriangular=True)
    z = z / d[..., None]
    x = torch.linalg.solve_triangular(lower.mT, z, upper=True, unitriangular=True)
    return x[..., 0] if vector else x.mT


def ldlt_num_neg_eigvals(fact):
    """Inertia per matrix of (..., n, n): by Sylvester's law the number of
    negative eigenvalues equals the number of negative entries of D."""
    return torch.sum(torch.diagonal(fact, dim1=-2, dim2=-1) < 0.0, dim=-1)
