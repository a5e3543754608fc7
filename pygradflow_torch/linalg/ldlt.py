"""Dense LDL^T: the plain rank-1 factor, the packed-factor solve and the
inertia count (counterpart of ``pygradflow_tpu/linalg/ldlt.py``).

Unpivoted: the saddle systems solved here are quasi-definite after the
``+ lambda I`` primal shift, for which the unpivoted factorization exists.
A zero pivot poisons the factor with NaN; the step layer turns that into a
rejected step with doubled lambda.
"""

import torch


def ldlt_factor(mat):
    """Packed factor by n rank-1 Schur updates: strict lower triangle holds
    L (unit diagonal implied), the diagonal holds D."""
    a = mat.clone()
    n = a.shape[-1]
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    for k in range(n):
        d = a[k, k]
        inv = torch.where(d != 0.0, 1.0 / d, nan)
        col = a[k + 1 :, k] * inv
        a[k + 1 :, k + 1 :] -= d * col[:, None] * col[None, :]
        a[k + 1 :, k] = col
    return a


def ldlt_solve(fact, rhs):
    """Solve ``L D L^T x = rhs`` for a vector ``rhs`` from the packed factor.
    The triangular solves stay library calls, as they were XLA ops outside
    any kernel in the JAX package."""
    n = fact.shape[-1]
    lower = torch.tril(fact, diagonal=-1) + torch.eye(n, dtype=fact.dtype, device=fact.device)
    d = torch.diagonal(fact)
    z = torch.linalg.solve_triangular(lower, rhs[:, None], upper=False, unitriangular=True)
    z = z / d[:, None]
    x = torch.linalg.solve_triangular(lower.T, z, upper=True, unitriangular=True)
    return x[:, 0]


def ldlt_num_neg_eigvals(fact):
    """Inertia: by Sylvester's law the number of negative eigenvalues equals
    the number of negative entries of D."""
    return torch.sum(torch.diagonal(fact) < 0.0)
