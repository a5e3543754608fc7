"""Restarted GMRES (the port's own copy of the algorithm of
``jax.scipy.sparse.linalg.gmres`` with ``solve_method="batched"``, which
``pygradflow_tpu/linalg/__init__.py`` calls with ``rtol = atol = 1e-12``).

- ``gmres``: ``restart = min(20, n)`` Krylov vectors per restart, at most
  ``maxiter = 10 n`` restarts, the stop ``||b - A x|| <= max(tol ||b||,
  atol)`` tested between restarts;
- one restart (``_restart``): a full Arnoldi process with no early exit on
  the residual, each new vector orthogonalised by classical Gram-Schmidt
  against all Krylov columns (JAX's ``_iterative_classical_gram_schmidt``
  with ``max_iterations=2``, whose condition for a second pass never holds,
  so one pass), an Arnoldi breakdown ending the process, and the small
  least-squares problem solved by its normal equations through Cholesky;
- the ``eps`` thresholds of JAX's ``_safe_normalize``: a norm at or below
  the threshold counts as 0 and gives the zero vector.

The same code serves one system and a lane stack.  A lane that has
converged, or has had its ``maxiter`` restarts, is frozen; a lane whose
Arnoldi process breaks down keeps its basis for the rest of the restart.
The restarts end when no lane still runs, read on the host once per
restart; on a CUDA device once per ``GRAPH_RESTARTS`` restarts, which are
captured once per call as a CUDA graph and replayed.  Frozen lanes make
the result independent of how often the host reads.  The JAX package's
summation orders differ, so results agree with it to rounding, not bit for
bit.
"""

import torch

from ..graphs import cuda_graphed
from ..util import any_running, lanes, matvec

GRAPH_RESTARTS = 8
"""Restarts between two host reads on a CUDA device, replayed as one CUDA
graph (each restart is about 400 small kernels)."""


def _safe_normalize(x, thresh):
    """``x / ||x||`` and ``||x||``, or the zero vector and 0 where the norm
    is at or below ``thresh``."""
    norm = torch.linalg.vector_norm(x, dim=-1)
    use = norm > thresh
    unit = torch.where(lanes(use, 1), x / lanes(norm, 1), 0.0)
    return unit, torch.where(use, norm, 0.0)


def _restart(mv, b, x0, unit_residual, residual_norm, restart: int):
    """One restart: the Krylov space of ``restart`` vectors from the unit
    residual, and the projection of the solution onto it."""
    eps = torch.finfo(b.dtype).eps
    lead = b.shape[:-1]
    n = b.shape[-1]
    V = torch.zeros(lead + (n, restart + 1), dtype=b.dtype, device=b.device)
    V[..., 0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device).repeat(lead + (1, 1))
    broke = torch.zeros(lead, dtype=torch.bool, device=b.device)
    for k in range(restart):
        v = mv(V[..., k])
        v_norm_0 = torch.linalg.vector_norm(v, dim=-1)
        v_norm_0 = torch.where(v_norm_0 > eps, v_norm_0, 0.0)
        h = matvec(V.mT, v)
        unit_v, v_norm_1 = _safe_normalize(v - matvec(V, h), eps * v_norm_0)
        h[..., k + 1] = v_norm_1
        # a lane broken down earlier keeps its zero column and identity row
        V[..., k + 1] = torch.where(lanes(broke, 1), 0.0, unit_v)
        H[..., k, :] = torch.where(lanes(broke, 1), H[..., k, :], h)
        broke = broke | (v_norm_1 == 0.0)

    beta = torch.zeros(lead + (restart + 1,), dtype=b.dtype, device=b.device)
    beta[..., 0] = residual_norm
    # the least-squares problem min ||H^T y - beta|| by its normal equations
    lower, info = torch.linalg.cholesky_ex(H @ H.mT)
    z = torch.linalg.solve_triangular(lower, matvec(H, beta)[..., None], upper=False)
    y = torch.linalg.solve_triangular(lower.mT, z, upper=True)[..., 0]
    y = torch.where(lanes(info != 0, 1), float("nan"), y)
    x = x0 + matvec(V[..., :-1], y)
    unit, norm = _safe_normalize(b - mv(x), eps)
    return x, unit, norm


def _restarts(mv, b, stop, maxiter: int, restart: int, count: int, x, unit, norm, k):
    """``count`` masked restarts: a lane that has converged, or has had its
    ``maxiter`` restarts (``k`` counts them), keeps its values bit for bit."""
    for _ in range(count):
        running = (norm > stop) & (k < maxiter)
        x_n, unit_n, norm_n = _restart(mv, b, x, unit, norm, restart)
        x = torch.where(lanes(running, 1), x_n, x)
        unit = torch.where(lanes(running, 1), unit_n, unit)
        norm = torch.where(running, norm_n, norm)
        k = k + running
    return x, unit, norm, k


def gmres(A, b, x0=None, tol=1e-12, atol=1e-12, restart=20, maxiter=None):
    """Solve ``A x = b`` (``A`` a matrix, a stack or a callable matvec)."""
    mv = A if callable(A) else (lambda v: matvec(A, v))
    n = b.shape[-1]
    if maxiter is None:
        maxiter = 10 * n
    restart = min(restart, n)
    eps = torch.finfo(b.dtype).eps

    x = torch.zeros_like(b) if x0 is None else x0
    stop = torch.clamp(tol * torch.linalg.vector_norm(b, dim=-1), min=atol)
    unit, norm = _safe_normalize(b - mv(x), eps)
    state = (x, unit, norm, torch.zeros(b.shape[:-1], dtype=torch.int64, device=b.device))
    per_read = GRAPH_RESTARTS if b.is_cuda else 1

    def chunk(*s):
        return _restarts(mv, b, stop, maxiter, restart, per_read, *s)

    if b.is_cuda:
        chunk = cuda_graphed(chunk, state)
    while any_running((state[2] > stop) & (state[3] < maxiter), "gmres"):
        state = chunk(*state)
    return state[0].clone()
