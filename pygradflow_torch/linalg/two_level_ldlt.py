"""Residual guard of the mixed-precision tier (counterpart of
``pygradflow_tpu/linalg/two_level_ldlt.py:194-233``).

Only the guard is ported here; the two-level factorization itself and the
panel-batched factor are ROADMAP A8.
"""

import torch


def ldlt_factor_residual(packed, mat):
    """O(n^2) quality probe: relative residual of ``L D L^T v`` against
    ``A v`` for the fixed probe ``v = cos(0.7 i + 0.3)`` in the factor's
    precision.  A genuine factor reads about n * eps; a broken one many
    orders of magnitude more."""
    n = packed.shape[-1]
    dtype = packed.dtype
    v = torch.cos(torch.arange(n, dtype=dtype, device=packed.device) * 0.7 + 0.3)
    strict = torch.tril(packed, diagonal=-1)
    d = torch.diagonal(packed)
    w = v + strict.T @ v
    y = d * w
    z = y + strict @ y
    a = mat.to(dtype)
    num = torch.linalg.vector_norm(z - a @ v)
    den = torch.linalg.matrix_norm(a) * torch.linalg.vector_norm(v)
    return num / torch.clamp(den, min=torch.finfo(dtype).tiny)


def guard_factor(packed, mat, rel_tol: float = 1e-2):
    """Poison ``packed`` with NaN when its residual probe is not below
    ``rel_tol``; a NaN residual (an already poisoned factor) stays poison."""
    ok = ldlt_factor_residual(packed, mat) < rel_tol
    return torch.where(ok, packed, torch.full_like(packed, float("nan")))
