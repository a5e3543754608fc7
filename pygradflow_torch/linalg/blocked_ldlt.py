"""Blocked LDL^T in plain torch (counterpart of
``pygradflow_tpu/linalg/blocked_ldlt.py``).

NB-column panels: NB rank-1 column steps restricted to the panel's
columns, over the rows below the pivot, then the trailing update of the
whole panel as one product, ``A[e:, e:] -= (L_p D_p) L_p^T``.  The JAX
package computes it in XLA outside any kernel, so it stays torch ops here;
the product is a library matmul.  The f64 dense tiers use it (the LDLT
tier, the dense dual Schur complement, a BCR root that the f32 tier does
not take).
"""

import torch

from .ldlt import ldlt_factor

DEFAULT_BLOCK = 128


def ldlt_factor_blocked(mat, block: int = DEFAULT_BLOCK):
    """Packed LDL^T of (..., n, n), in the layout of ``ldlt_factor``: strict
    lower triangle L, diagonal D.  Padded with identity to a multiple of
    ``block``; the rank-1 factor for n <= ``block``.

    Each column step rounds as the JAX one: the update of entry (i, j) is
    ``(d * l_i) * (a_kj / d)``, not ``ldlt_factor``'s ``(d * l_i) * l_j``."""
    from .ldlt_kernels import pad_identity

    n = mat.shape[-1]
    if n <= block:
        return ldlt_factor(mat)
    a = pad_identity(mat, block)
    n_pad = a.shape[-1]
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    for base in range(0, n_pad, block):
        e = base + block
        for k in range(base, e):
            d = a[..., k, k]
            inv = torch.where(d != 0.0, 1.0 / d, nan)
            col = a[..., k + 1 :, k] * inv[..., None]
            row = a[..., k, k + 1 : e] * inv[..., None]
            a[..., k + 1 :, k + 1 : e] -= (d[..., None] * col)[..., :, None] * row[..., None, :]
            a[..., k + 1 :, k] = col
        if e < n_pad:
            lp = a[..., e:, base:e]
            dvals = torch.diagonal(a[..., base:e, base:e], dim1=-2, dim2=-1)
            a[..., e:, e:] -= (lp * dvals[..., None, :]) @ lp.mT
    return a[..., :n, :n]
