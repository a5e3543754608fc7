"""The panel-batched LDL^T and the residual guard of the mixed-precision
tier (counterpart of ``pygradflow_tpu/linalg/two_level_ldlt.py``).

``ldlt_factor_two_level`` (single matrices above n = 2048) is ROADMAP A8.
"""

import torch

from ..util import matvec
from .ldlt import ldlt_factor


def ldlt_factor_batched_panels(mat, super_block: int = 128):
    """Packed f32 LDL^T of a (..., n, n) stack by super-blocks of width
    ``super_block`` (reference ``two_level_ldlt.py:118-191``): the rank-1
    factor of each diagonal block over every instance at once, then a
    batched triangular solve for the panel below and a batched product for
    the trailing update.  The last two are library calls, as they were XLA
    ops outside any kernel in the JAX package."""
    from .ldlt_kernels import pad_identity

    mat = mat.to(torch.float32)
    n = mat.shape[-1]
    a = pad_identity(mat, super_block)
    n_pad = a.shape[-1]
    eye = torch.eye(super_block, dtype=torch.float32, device=a.device)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=a.device)
    for s in range(0, n_pad, super_block):
        e = s + super_block
        packed = ldlt_factor(a[..., s:e, s:e])
        a[..., s:e, s:e] = packed
        if e == n_pad:
            break
        d = torch.diagonal(packed, dim1=-2, dim2=-1)
        lower = torch.tril(packed, diagonal=-1) + eye
        # X = P L^{-T}: solve L Y = P^T, X = Y^T
        y = torch.linalg.solve_triangular(
            lower, a[..., e:, s:e].mT, upper=False, unitriangular=True
        )
        x = y.mT
        inv_d = torch.where(d != 0.0, 1.0 / d, nan)
        l_panel = x * inv_d[..., None, :]
        a[..., e:, s:e] = l_panel
        a[..., e:, e:] -= l_panel @ x.mT
    return a[..., :n, :n]


def ldlt_factor_residual(packed, mat):
    """O(n^2) quality probe per matrix of (..., n, n): relative residual of
    ``L D L^T v`` against ``A v`` for the fixed probe ``v = cos(0.7 i +
    0.3)`` in the factor's precision.  A genuine factor reads about n * eps;
    a broken one many orders of magnitude more."""
    n = packed.shape[-1]
    dtype = packed.dtype
    v = torch.cos(torch.arange(n, dtype=dtype, device=packed.device) * 0.7 + 0.3)
    strict = torch.tril(packed, diagonal=-1)
    d = torch.diagonal(packed, dim1=-2, dim2=-1)
    w = v + strict.mT @ v
    y = d * w
    z = y + matvec(strict, y)
    a = mat.to(dtype)
    num = torch.linalg.vector_norm(z - a @ v, dim=-1)
    den = torch.linalg.matrix_norm(a, dim=(-2, -1)) * torch.linalg.vector_norm(v)
    return num / torch.clamp(den, min=torch.finfo(dtype).tiny)


def guard_factor(packed, mat, rel_tol: float = 1e-2):
    """Poison each matrix of ``packed`` with NaN when its residual probe is
    not below ``rel_tol``; a NaN residual (an already poisoned factor) stays
    poison.  Lanes of a stack are judged one by one."""
    ok = ldlt_factor_residual(packed, mat) < rel_tol
    return torch.where(ok[..., None, None], packed, torch.full_like(packed, float("nan")))
