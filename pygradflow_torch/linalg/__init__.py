"""Linear-solver backends for the KKT systems (counterpart of
``pygradflow_tpu/linalg/__init__.py``).

Every backend has the same interface: factor, (transpose-)solve and the
inertia query.  A failed factorization does not raise: it leaves NaN in the
factor, and the step layer turns the non-finite step into a rejected one.

This port serves ``LinearSolverType.PallasLDLT`` only.  The enum keeps its
name so that configurations carry over; on this port it is the
hand-written-kernel mixed-precision tier: a packed f32 LDL^T from the CUDA
kernels of ``csrc/ldlt.cu`` (their plain PyTorch versions for CPU tensors),
checked by a residual probe, then f64 iterative refinement.
"""

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..params import LinearSolverType


class LinearSolverError(Exception):
    """Raised eagerly for unsupported configurations."""


class LinearSolver(NamedTuple):
    """Bundle of factor/solve closures for one backend."""

    factor: Callable[[Any], Any]
    solve: Callable[..., Any]  # (fact, rhs) -> sol
    solve_trans: Callable[[Any, Any], Any]
    num_neg_eigvals: Optional[Callable[[Any], Any]]
    name: str


# Size limits of the reference tiers, kept so that every KKT size reaches
# the same algorithm as in the JAX package.  They came from TPU VMEM and
# Mosaic limits; re-deriving them for the H100 is later work (ROADMAP A8).
PALLAS_MAX_N = 1280
PALLAS_HBM_MAX_N = 2048


def factor_route(n: int) -> str:
    """Kernel that factors an (n, n) KKT matrix: "rl" (right-looking) up to
    PALLAS_MAX_N, "ll" (left-looking) up to PALLAS_HBM_MAX_N."""
    if n <= PALLAS_MAX_N:
        return "rl"
    if n <= PALLAS_HBM_MAX_N:
        return "ll"
    raise NotImplementedError(
        f"KKT size {n} > {PALLAS_HBM_MAX_N} needs the two-level LDL^T "
        "factorization, not yet ported (ROADMAP A8)"
    )


def _pallas_ldlt() -> LinearSolver:
    from .ldlt import ldlt_num_neg_eigvals
    from .ldlt_kernels import ldlt_factor_ll, ldlt_factor_rl, refine_solve
    from .two_level_ldlt import guard_factor

    kernels = {"rl": ldlt_factor_rl, "ll": ldlt_factor_ll}

    def factor(mat):
        if mat.ndim != 2:
            raise NotImplementedError(
                "batched factorizations (kernel B2) are not yet ported (ROADMAP A7)"
            )
        kernel = kernels[factor_route(mat.shape[-1])]
        packed = kernel(mat.to(torch.float32).contiguous())
        return (guard_factor(packed, mat), mat)

    def solve(fact, rhs):
        packed, mat = fact
        return refine_solve(packed, mat, rhs)

    def num_neg(fact):
        packed, _ = fact
        return ldlt_num_neg_eigvals(packed)

    return LinearSolver(factor, solve, solve, num_neg, "pallas_ldlt")


_ROADMAP = {
    LinearSolverType.LU: "A4",
    LinearSolverType.Cholesky: "A4",
    LinearSolverType.LDLT: "A4",
    LinearSolverType.MINRES: "A8",
    LinearSolverType.GMRES: "A8",
}


def linear_solver(solver_type: LinearSolverType, symmetric: bool = False) -> LinearSolver:
    """Factory keyed on ``LinearSolverType``."""
    if solver_type == LinearSolverType.PallasLDLT:
        return _pallas_ldlt()
    if solver_type in _ROADMAP:
        raise NotImplementedError(
            f"linear solver {solver_type.name} is not yet ported "
            f"(ROADMAP {_ROADMAP[solver_type]})"
        )
    raise LinearSolverError(f"Unknown linear solver type {solver_type}")
