"""Randomized reciprocal-condition-number estimate (counterpart of
``pygradflow_tpu/step/cond_estimate.py``).

Dixon's power-iteration estimator ("Estimating Extremal Eigenvalues and
Condition Numbers of Matrices"): ``||A||_2`` by power iteration with
``A^T A`` products, ``||A^-1||_2`` by pairs of transposed and plain solves
with an existing factorization, both from fixed-seed random unit vectors.
The iteration count depends only on the size and the confidence.

The JAX package draws its probes with ``jax.random.PRNGKey(42)``, which
torch cannot reproduce.  Here :func:`probe_vectors` draws them on the CPU
from a ``torch.Generator`` seeded 42, in float64, and moves them to the
device, so a run on the CPU and one on the card use the same probes.  A
matrix or a lane stack: every lane uses the same pair of probes.
"""

import math

import torch

from ..util import dot, lanes, matvec

SEED = 42


def required_its(size: int, min_prob: float = 0.99, factor: float = 10.0) -> int:
    f = (1.0 - min_prob) / 1.6 * math.pow(size, -0.5)
    return -2 * math.ceil(math.log(f, factor))


_PROBES = {}


def probe_vectors(size: int, dtype, device):
    """The two unit probe vectors (x, y) of length ``size``, made once per
    size, dtype and device: a copy from host memory inside the solve loop's
    iteration would stop it from being captured as a CUDA graph."""
    key = (size, dtype, torch.device(device))
    if key not in _PROBES:
        _PROBES[key] = _make_probes(size, dtype, device)
    return _PROBES[key]


def _make_probes(size: int, dtype, device):
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(size, generator=gen, dtype=torch.float64)
    y = torch.randn(size, generator=gen, dtype=torch.float64)
    x = x / torch.linalg.vector_norm(x)
    y = y / torch.linalg.vector_norm(y)
    return x.to(dtype=dtype, device=device), y.to(dtype=dtype, device=device)


def _normalized(v):
    norm = torch.linalg.vector_norm(v, dim=-1)
    return v / lanes(torch.where(norm == 0.0, 1.0, norm), 1), norm


def estimate_rcond(mat, solve, solve_trans, min_prob: float = 0.99, factor: float = 10.0):
    """Estimate 1 / cond_2(mat), one value per lane of a stack;
    ``solve``/``solve_trans`` solve with an existing factorization."""
    size = mat.shape[-1]
    num_its = required_its(size, min_prob, factor)
    x, y = probe_vectors(size, mat.dtype, mat.device)
    x = x.expand(mat.shape[:-1]).contiguous()
    y = y.expand(mat.shape[:-1]).contiguous()

    xprod, yprod = x, y
    xfac = torch.ones(mat.shape[:-2], dtype=mat.dtype, device=mat.device)
    yfac = xfac
    for _ in range(num_its):
        xprod, xnorm = _normalized(matvec(mat.mT, matvec(mat, xprod)))
        yprod, ynorm = _normalized(solve(solve_trans(yprod)))
        xfac = xfac * xnorm
        yfac = yfac * ynorm

    pow_fac = 1.0 / (2.0 * num_its)
    xdot = (dot(x, xprod) * xfac) ** pow_fac
    ydot = (dot(y, yprod) * yfac) ** pow_fac
    cond = xdot * ydot
    return torch.where(torch.isinf(cond) | torch.isnan(cond), 0.0, 1.0 / cond)
