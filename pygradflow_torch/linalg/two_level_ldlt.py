"""Super-block LDL^T factors and the residual guard of the mixed-precision
tier (counterpart of ``pygradflow_tpu/linalg/two_level_ldlt.py``).

Both factors work super-block by super-block on an f32 matrix or stack::

    A[k,k]  -> packed LDL^T          diagonal block
    X  = A[k+1:, k] L_kk^{-T}        one triangular solve
    L[k+1:, k] = X D_k^{-1}          column scaling
    A[k+1:, k+1:] -= X D_k^{-1} X^T  one product

- :func:`ldlt_factor_two_level` (n > 2048): the diagonal blocks through
  the right-looking kernel B1' (``ldlt_factor_rl``), a stack of them as
  the JAX package's vmap rule routes it;
- :func:`ldlt_factor_batched_panels` (stacks padded to 512 and more): the
  diagonal blocks through the rank-1 ``ldlt_factor`` over every lane.

The triangular solve and the product are library calls, as they were XLA
ops outside any kernel in the JAX package.
"""

import torch

from ..util import matvec
from .ldlt import ldlt_factor

MAX_SUPER_BLOCK = 1280
"""The right-looking kernel's limit (PALLAS_MAX_N): the two-level factor may
pick any super-block up to it."""


def _super_block_factor(mat, super_block, diag_factor):
    """Packed f32 LDL^T of (..., n, n), padded with identity to a multiple
    of ``super_block``; ``diag_factor`` factors each diagonal block."""
    from .ldlt_kernels import pad_identity

    mat = mat.to(torch.float32)
    n = mat.shape[-1]
    a = pad_identity(mat, super_block)
    n_pad = a.shape[-1]
    eye = torch.eye(super_block, dtype=torch.float32, device=a.device)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=a.device)
    for s in range(0, n_pad, super_block):
        e = s + super_block
        packed = diag_factor(a[..., s:e, s:e].contiguous())
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


def ldlt_factor_batched_panels(mat, super_block: int = 128):
    """Packed f32 LDL^T of a (..., n, n) stack by super-blocks of width
    ``super_block`` (reference ``two_level_ldlt.py:118-191``): the rank-1
    factor of each diagonal block over every instance at once."""
    return _super_block_factor(mat, super_block, ldlt_factor)


def _diag_block_factor(block):
    """B1's factor of one diagonal block, or of a stack of them as the JAX
    package's ``custom_vmap`` rule routes it (``pallas_ldlt.py:143``):
    padded to 128, the batched kernel below 512, the panel-batched factor
    from there."""
    from . import PANEL_BATCH_MIN_N
    from .ldlt_kernels import RL_BLOCK, _padded_size, ldlt_factor_rl, ldlt_factor_rl_batched, pad_identity

    if block.ndim == 2:
        return ldlt_factor_rl(block)
    n = block.shape[-1]
    if _padded_size(n, RL_BLOCK) < PANEL_BATCH_MIN_N:
        return ldlt_factor_rl_batched(block)
    return ldlt_factor_batched_panels(pad_identity(block, RL_BLOCK))[..., :n, :n]


def ldlt_factor_two_level(mat, super_block=None):
    """Packed f32 LDL^T of an (n, n) matrix or a (B, n, n) stack
    (reference ``two_level_ldlt.py:45-115``).

    ``super_block=None`` takes the fewest super-blocks that fit the
    right-looking kernel and sizes them to pad least: n = 2050 becomes
    2 x 1025, not 3 x 1024 (padding costs cubically)."""
    n = mat.shape[-1]
    if super_block is None:
        num_min = -(-n // MAX_SUPER_BLOCK)
        super_block = -(-n // num_min) if n > MAX_SUPER_BLOCK else n
    if n <= super_block:
        return _diag_block_factor(mat.to(torch.float32).contiguous())
    return _super_block_factor(mat, super_block, _diag_block_factor)


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
