"""Linear-solver backends for the KKT systems (counterpart of
``pygradflow_tpu/linalg/__init__.py``).

Every backend has the same interface: factor, (transpose-)solve and the
inertia query.  A failed factorization does not raise: it leaves NaN in the
factor, and the step layer turns the non-finite step into a rejected one.

Each tier takes one matrix (n, n) or a lane stack (B, n, n):

- ``LinearSolverType.LU``, the default: partial-pivot LU in plain torch
  (``plu.py``), as the JAX package computes it outside any kernel.
- ``LinearSolverType.Cholesky``: ``torch.linalg.cholesky_ex``; a matrix
  that is not positive definite gets a NaN factor, as JAX's ``cho_factor``
  gives it.
- ``LinearSolverType.LDLT``: the unpivoted f64 LDL^T with inertia, blocked
  (``blocked_ldlt.py``) above ``LDLT_BLOCKED_MIN_N``, rank-1 below.
- ``LinearSolverType.PallasLDLT``.  The enum keeps its name so that
  configurations carry over; on this port it is the hand-written-kernel
  mixed-precision tier: a packed f32 LDL^T from the CUDA kernels of
  ``csrc/ldlt.cu`` (their plain PyTorch versions for CPU tensors), checked
  by a residual probe, then iterative refinement in the matrix's dtype
  (f64, or f32 under ``Precision.Single``).
- ``LinearSolverType.MINRES`` (symmetric only) and ``LinearSolverType.GMRES``:
  the iterative solvers of ``minres.py`` and ``gmres.py`` on the assembled
  matrix, with the warm start a step solver passes as ``initial_sol``.

Every ``solve`` takes ``initial_sol``; the direct tiers ignore it.
"""

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..params import LinearSolverType


class LinearSolverError(Exception):
    """Raised eagerly for unsupported configurations."""


class LinearSolver(NamedTuple):
    """Bundle of factor/solve closures for one backend."""

    factor: Callable[[Any], Any]
    solve: Callable[..., Any]  # (fact, rhs, initial_sol=None) -> sol
    solve_trans: Callable[[Any, Any], Any]
    num_neg_eigvals: Optional[Callable[[Any], Any]]
    name: str


# Size limits of the reference tiers, kept so that every KKT size reaches
# the same algorithm as in the JAX package.  They came from TPU VMEM and
# Mosaic limits; re-deriving them for the H100 is later work (ROADMAP F4).
PALLAS_MAX_N = 1280
PALLAS_HBM_MAX_N = 2048
PANEL_BATCH_MIN_N = 512
"""Padded size from which a stack takes the panel-batched factor instead of
the batched kernel (``pallas_ldlt.py:34``)."""

LDLT_BLOCKED_MIN_N = 192
"""Above this size the LDLT tier takes the blocked factor."""


def factor_route(n: int, batched: bool = False) -> str:
    """How an (n, n) KKT matrix, or a stack of them, is factored.

    Above PALLAS_HBM_MAX_N: "two_level" (``ldlt_factor_two_level``), for one
    matrix and a stack.  Below it, one matrix: "rl" (right-looking kernel)
    up to PALLAS_MAX_N, "ll" (left-looking kernel) up to PALLAS_HBM_MAX_N.
    A stack, as the JAX package's vmap rules route it: padded to 128 up to
    PALLAS_MAX_N, then "rl_batched" (batched kernel) below
    PANEL_BATCH_MIN_N and "panels" (``ldlt_factor_batched_panels``) from
    there; padded to 256 and "panels" up to PALLAS_HBM_MAX_N."""
    from .ldlt_kernels import RL_BLOCK, _padded_size

    if n > PALLAS_HBM_MAX_N:
        return "two_level"
    if not batched:
        return "rl" if n <= PALLAS_MAX_N else "ll"
    if n <= PALLAS_MAX_N and _padded_size(n, RL_BLOCK) < PANEL_BATCH_MIN_N:
        return "rl_batched"
    return "panels"


def _pallas_ldlt() -> LinearSolver:
    from .ldlt import ldlt_num_neg_eigvals
    from .ldlt_kernels import (
        RL_BLOCK,
        ldlt_factor_ll,
        ldlt_factor_rl,
        ldlt_factor_rl_batched,
        pad_identity,
        refine_solve,
    )
    from .two_level_ldlt import guard_factor, ldlt_factor_batched_panels, ldlt_factor_two_level

    def panels(mat):
        n = mat.shape[-1]
        # the reference pads with identity before it routes: to 128 (the
        # VMEM kernel's panel) up to PALLAS_MAX_N, to 256 (the HBM kernel's)
        # above
        block = RL_BLOCK if n <= PALLAS_MAX_N else 2 * RL_BLOCK
        return ldlt_factor_batched_panels(pad_identity(mat, block))[..., :n, :n]

    kernels = {
        "rl": ldlt_factor_rl,
        "ll": ldlt_factor_ll,
        "rl_batched": ldlt_factor_rl_batched,
        "panels": panels,
        "two_level": ldlt_factor_two_level,
    }

    def factor(mat):
        if mat.ndim not in (2, 3):
            raise ValueError(f"expected a matrix or a stack, got {tuple(mat.shape)}")
        kernel = kernels[factor_route(mat.shape[-1], batched=mat.ndim == 3)]
        packed = kernel(mat.to(torch.float32).contiguous())
        return (guard_factor(packed, mat), mat)

    def solve(fact, rhs, initial_sol=None, iters: int = 3):
        """``iters=0`` skips the f64 refinement (the raw f32 back-solve),
        for callers that refine around this solve themselves (the
        mixed-precision Schur saddle refinement)."""
        packed, mat = fact
        return refine_solve(packed, mat, rhs, iters=iters)

    def num_neg(fact):
        packed, _ = fact
        return ldlt_num_neg_eigvals(packed)

    return LinearSolver(factor, solve, solve, num_neg, "pallas_ldlt")


def _lu() -> LinearSolver:
    from .plu import plu_factor, plu_solve, plu_solve_trans

    def solve(fact, rhs, initial_sol=None):
        return plu_solve(fact, rhs)

    return LinearSolver(plu_factor, solve, plu_solve_trans, None, "lu")


def _cholesky() -> LinearSolver:
    """Positive definite matrices only: ``cholesky_ex`` does not raise, and
    a lane whose factorization fails gets a NaN factor, which the step
    layer rejects."""

    def factor(mat):
        lower, info = torch.linalg.cholesky_ex(mat)
        return torch.where((info != 0)[..., None, None], float("nan"), lower)

    def solve(fact, rhs, initial_sol=None):
        return torch.cholesky_solve(rhs[..., None], fact)[..., 0]

    def num_neg(fact):
        return torch.zeros(fact.shape[:-2], dtype=torch.int64, device=fact.device)

    return LinearSolver(factor, solve, solve, num_neg, "cholesky")


def _ldlt() -> LinearSolver:
    """f64 LDL^T with inertia.  JAX takes the blocked factor for a 2-D
    matrix above LDLT_BLOCKED_MIN_N, which under its BatchedSolver's vmap is
    every lane; so here each matrix of a stack takes it too."""
    from .blocked_ldlt import ldlt_factor_blocked
    from .ldlt import ldlt_factor, ldlt_num_neg_eigvals, ldlt_solve

    def factor(mat):
        if mat.shape[-1] > LDLT_BLOCKED_MIN_N:
            return ldlt_factor_blocked(mat)
        return ldlt_factor(mat)

    def solve(fact, rhs, initial_sol=None):
        return ldlt_solve(fact, rhs)

    return LinearSolver(factor, solve, solve, ldlt_num_neg_eigvals, "ldlt")


def _minres() -> LinearSolver:
    from .minres import minres

    def solve(mat, rhs, initial_sol=None):
        return minres(mat, rhs, x0=initial_sol)

    return LinearSolver(lambda mat: mat, solve, solve, None, "minres")


def _gmres() -> LinearSolver:
    """``rtol = atol = 1e-12``, as the JAX package passes them."""
    from .gmres import gmres

    def solve(mat, rhs, initial_sol=None):
        return gmres(mat, rhs, x0=initial_sol)

    def solve_trans(mat, rhs):
        return gmres(mat.mT, rhs)

    return LinearSolver(lambda mat: mat, solve, solve_trans, None, "gmres")


def linear_solver(solver_type: LinearSolverType, symmetric: bool = False) -> LinearSolver:
    """Factory keyed on ``LinearSolverType``."""
    if solver_type == LinearSolverType.LU:
        return _lu()
    if solver_type == LinearSolverType.Cholesky:
        return _cholesky()
    if solver_type == LinearSolverType.LDLT:
        return _ldlt()
    if solver_type == LinearSolverType.PallasLDLT:
        return _pallas_ldlt()
    if solver_type == LinearSolverType.MINRES:
        if not symmetric:
            raise LinearSolverError("MINRES requires a symmetric matrix")
        return _minres()
    if solver_type == LinearSolverType.GMRES:
        return _gmres()
    raise LinearSolverError(f"Unknown linear solver type {solver_type}")


# the factors and solvers the JAX package's linalg namespace exports
from .blocked_ldlt import ldlt_factor_blocked  # noqa: E402,F401
from .ldlt import ldlt_factor, ldlt_num_neg_eigvals, ldlt_solve  # noqa: E402,F401
from .minres import minres  # noqa: E402,F401
from .plu import plu_factor, plu_solve, plu_solve_trans  # noqa: E402,F401
