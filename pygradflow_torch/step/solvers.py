"""Step solvers: KKT assembly and solve for one semismooth Newton step
(counterpart of ``pygradflow_tpu/step/solvers.py``).

The formulations (lambda = 1/dt, fact = 1/(1 + lambda rho)), each a dense
``(n+m, n+m)`` system in which active variables get identity rows:

- Standard: the unscaled residual Jacobian ``implicit_func.deriv``, with
  the full augmented Hessian at the runtime rho;
- Asymmetric: ``[[H + lambda I, J^T], [J, -lambda fact I]]`` with identity
  rows for the active variables, ``H`` the plain Lagrangian Hessian;
  Extended shares its assembly, as in the JAX package;
- Symmetric (the default): the same system with the rows *and* columns of
  active variables replaced by identity and the right-hand side condensed
  to match, which keeps the matrix symmetric for LDL^T and its inertia
  test (m negative eigenvalues).

Standard and Asymmetric factor a non-symmetric matrix with the configured
tier, the PallasLDLT tier included, as the JAX package does.  With
``params.report_rcond`` each of the three estimates the reciprocal
condition number of its matrix from the factor (``cond_estimate.py``): on
the PallasLDLT tier the estimate's solves are the refined f64 solves around
the one f32 factor, so it adds solves and no factor.  The Schur tiers
report NaN, as in the JAX package.
``params.step_solver`` replaces all of this by a user's ``StepSolverDef``.

Assembly and solve serve one instance and a lane stack alike: with a
(B,) ``lamb`` and ``rho`` the KKT matrices are a (B, n+m, n+m) stack and
the linear solver factors them together.

``StepSolverType.Schur`` dispatches as in the JAX package: the dense or
block-tridiagonal dual (``schur.py``), or with ``matrix_free`` the staged
tier (``schur_staged.py``); the ``PallasLDLT`` tier serves their dual
factor, every other linear solver type the f64 path.
"""

from typing import Any, NamedTuple

import torch

from .. import implicit_func as impl
from ..iterate import Iterate
from ..linalg import LinearSolver, linear_solver
from ..params import LinearSolverType, Params, StepSolverType
from ..util import lanes, matvec, norm_mult


class StepResult(NamedTuple):
    """One Newton step with the primal update clipped into the box."""

    xn: Any
    yn: Any
    dx: Any
    dy: Any
    diff: Any
    active_set: Any
    rcond: Any  # reciprocal condition estimate (a float NaN when off)


def make_step_result(it: Iterate, dx, dy, lb, ub, active_set, rcond=float("nan")) -> StepResult:
    xn = it.x - dx
    at_lb = xn < lb
    at_ub = xn > ub
    xn = torch.clamp(xn, lb, ub)
    dxc = torch.where(at_lb, it.x - lb, torch.where(at_ub, it.x - ub, dx))
    yn = it.y - dy
    return StepResult(
        xn=xn,
        yn=yn,
        dx=dxc,
        dy=dy,
        diff=norm_mult(dxc, dy),
        active_set=active_set,
        rcond=rcond,
    )


class Factorization(NamedTuple):
    """Assembled and factored KKT system plus what the rhs needs."""

    fact: Any  # linear-solver factorization
    active: Any  # bool (n,)
    hess_shifted: Any  # H + lambda I, for the rhs condensation
    jac: Any
    inertia_ok: Any  # None (not tested) or bool per lane; False forces a NaN step
    rcond: Any = float("nan")  # estimate of params.report_rcond, per lane


def _maybe_rcond(lin: LinearSolver, report: bool, mat, fact):
    """The Dixon estimate of the assembled matrix when asked for (reference
    ``step/solver/step_solver.py:100-112``)."""
    if not report:
        return float("nan")
    from .cond_estimate import estimate_rcond

    return estimate_rcond(mat, lambda r: lin.solve(fact, r), lambda r: lin.solve_trans(fact, r))


class StepSolverDef(NamedTuple):
    """Closures assembling, factoring and solving one formulation."""

    scaled: bool
    symmetric: bool
    hess_rho_is_runtime: bool
    factor: Any  # (func, H, J, active, rho) -> Factorization
    solve: Any  # (factorization, func, cur_it, rho) -> (dx, dy)
    # a matrix-free def factors from (func, iterate, active, rho) and finds
    # the blocks it needs by jvp/hvp probes (step/schur_staged.py)
    matrix_free: bool = False


def _lower_block(m, lamb, rho, dtype, device):
    """The (…, m, m) lower-right block ``-lambda fact I`` of the scaled
    system, one per lane for a (B,) ``lamb``."""
    fact = 1.0 / (1.0 + lamb * rho)
    return -lanes(lamb * fact, 2) * torch.eye(m, dtype=dtype, device=device)


def step_solver_def(params: Params, fns=None) -> StepSolverDef:
    """The configured formulation; ``fns`` (the evaluation closures, lane
    closures in a batch) is what the matrix-free Schur def probes."""
    if params.step_solver is not None:
        # a callable params -> StepSolverDef (reference params.step_solver)
        return params.step_solver(params)
    solver_type = params.step_solver_type
    if params.matrix_free and solver_type != StepSolverType.Schur:
        raise ValueError(
            "matrix_free requires StepSolverType.Schur (the other "
            "formulations assemble the dense KKT system)"
        )
    if solver_type == StepSolverType.Schur:
        from .schur import schur_def

        if params.schur_block_size is None:
            raise ValueError("StepSolverType.Schur requires params.schur_block_size")
        schur_lin = (
            linear_solver(params.linear_solver_type, symmetric=True)
            if params.linear_solver_type == LinearSolverType.PallasLDLT
            else None
        )
        if params.matrix_free:
            from .schur_staged import schur_staged_def

            if params.schur_dual_block_size is None:
                raise ValueError(
                    "matrix_free Schur requires params.schur_dual_block_size "
                    "(stage-local constraints)"
                )
            return schur_staged_def(
                schur_lin, fns, params.schur_block_size, params.schur_dual_block_size
            )
        return schur_def(schur_lin, params.schur_block_size, params.schur_dual_block_size)
    symmetric = solver_type == StepSolverType.Symmetric
    lin = linear_solver(params.linear_solver_type, symmetric=symmetric)
    report = params.report_rcond
    if solver_type == StepSolverType.Standard:
        return _standard_def(lin, report)
    if symmetric:
        return _symmetric_def(lin, params.inertia_correction, report)
    return _asymmetric_def(lin, report)  # Asymmetric and Extended


def _standard_def(lin: LinearSolver, report_rcond: bool = False) -> StepSolverDef:
    def factor(func: impl.StepFunc, H, J, active, rho):
        mat = impl.deriv(func, J, H, active)
        fact = lin.factor(mat)
        return Factorization(
            fact=fact, active=active, hess_shifted=H, jac=J, inertia_ok=None,
            rcond=_maybe_rcond(lin, report_rcond, mat, fact),
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        rx, ry = impl.value_at(func, it, rho, f.active)
        sol = lin.solve(f.fact, torch.cat([rx, ry], dim=-1))
        n = rx.shape[-1]
        return sol[..., :n], sol[..., n:]

    return StepSolverDef(
        scaled=False,
        symmetric=False,
        hess_rho_is_runtime=True,
        factor=factor,
        solve=solve,
    )


def _asymmetric_def(lin: LinearSolver, report_rcond: bool = False) -> StepSolverDef:
    def factor(func: impl.StepFunc, H, J, active, rho):
        lamb = func.lamb
        n = H.shape[-1]
        m = J.shape[-2]
        eye_n = torch.eye(n, dtype=H.dtype, device=H.device)

        Hl = H + lanes(lamb, 2) * eye_n
        act_col = active[..., :, None]
        M11 = torch.where(act_col, eye_n, Hl)
        M12 = torch.where(act_col, 0.0, J.mT)
        M22 = _lower_block(m, lamb, rho, H.dtype, H.device).expand(J.shape[:-2] + (m, m))

        mat = torch.cat(
            [torch.cat([M11, M12], dim=-1), torch.cat([J, M22], dim=-1)], dim=-2
        )
        fact = lin.factor(mat)
        return Factorization(
            fact=fact, active=active, hess_shifted=Hl, jac=J, inertia_ok=None,
            rcond=_maybe_rcond(lin, report_rcond, mat, fact),
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        lamb = func.lamb
        dt = 1.0 / lamb
        pfact = 1.0 / (1.0 + lamb * rho)

        rx, ry = impl.value_at(func, it, rho, f.active)
        n = rx.shape[-1]
        var_rhs = torch.where(f.active, lanes(dt, 1) * rx, rx)
        sol0 = torch.cat([torch.where(f.active, lanes(dt, 1) * rx, 0.0), torch.zeros_like(ry)], dim=-1)
        sol = lin.solve(f.fact, torch.cat([var_rhs, lanes(pfact, 1) * ry], dim=-1), initial_sol=sol0)
        dx = sol[..., :n]
        dy = lanes(pfact, 1) * (sol[..., n:] - lanes(rho, 1) * ry)
        return dx, dy

    return StepSolverDef(
        scaled=True,
        symmetric=False,
        hess_rho_is_runtime=False,
        factor=factor,
        solve=solve,
    )


def _symmetric_def(lin: LinearSolver, inertia_correction: bool, report_rcond: bool = False) -> StepSolverDef:
    def factor(func: impl.StepFunc, H, J, active, rho):
        lamb = func.lamb
        n = H.shape[-1]
        m = J.shape[-2]
        eye_n = torch.eye(n, dtype=H.dtype, device=H.device)

        Hl = H + lanes(lamb, 2) * eye_n
        inact = ~active
        both_inact = inact[..., :, None] & inact[..., None, :]

        M11 = torch.where(both_inact, Hl, 0.0) + torch.diag_embed(active.to(H.dtype))
        M12 = torch.where(inact[..., :, None], J.mT, 0.0)
        M22 = _lower_block(m, lamb, rho, H.dtype, H.device)

        mat = torch.cat(
            [torch.cat([M11, M12], dim=-1), torch.cat([M12.mT, M22], dim=-1)], dim=-2
        )
        factored = lin.factor(mat)

        inertia_ok = None
        if inertia_correction:
            if lin.num_neg_eigvals is None:
                raise ValueError(
                    "Inertia correction requested but linear solver "
                    f"'{lin.name}' provides no inertia"
                )
            # expect exactly m negative eigenvalues
            # (reference symmetric_step_solver.py:146-153)
            inertia_ok = lin.num_neg_eigvals(factored) == m

        return Factorization(
            fact=factored, active=active, hess_shifted=Hl, jac=J, inertia_ok=inertia_ok,
            rcond=_maybe_rcond(lin, report_rcond, mat, factored),
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        lamb = func.lamb
        dt = 1.0 / lamb
        pfact = 1.0 / (1.0 + lamb * rho)

        rx, ry = impl.value_at(func, it, rho, f.active)
        n = rx.shape[-1]

        b0_full = torch.where(f.active, lanes(dt, 1) * rx, 0.0)
        # condensed rhs (reference symmetric_step_solver.py:79-94)
        rhs_x = torch.where(f.active, b0_full, rx - matvec(f.hess_shifted, b0_full))
        rhs_y = lanes(pfact, 1) * ry - matvec(f.jac, b0_full)
        sol = lin.solve(f.fact, torch.cat([rhs_x, rhs_y], dim=-1))

        dx = sol[..., :n]
        dy = lanes(pfact, 1) * (sol[..., n:] - lanes(rho, 1) * ry)
        if f.inertia_ok is not None:
            dx = torch.where(lanes(f.inertia_ok, 1), dx, float("nan"))
        return dx, dy

    return StepSolverDef(
        scaled=True,
        symmetric=True,
        hess_rho_is_runtime=False,
        factor=factor,
        solve=solve,
    )
