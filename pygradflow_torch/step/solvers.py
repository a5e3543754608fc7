"""Step solvers: KKT assembly and solve for one semismooth Newton step
(counterpart of ``pygradflow_tpu/step/solvers.py``).

The Symmetric formulation is ported (scaled, lambda = 1/dt,
fact = 1/(1 + lambda rho)): the system ``[[H + lambda I, J^T], [J,
-lambda fact I]]`` with the rows *and* columns of active variables replaced
by identity and the right-hand side condensed to match, which keeps the
matrix symmetric for LDL^T and its inertia test (m negative eigenvalues).
"""

from typing import Any, NamedTuple

import torch

from .. import implicit_func as impl
from ..iterate import Iterate
from ..linalg import LinearSolver, linear_solver
from ..params import Params, StepSolverType
from ..util import norm_mult


class StepResult(NamedTuple):
    """One Newton step with the primal update clipped into the box."""

    xn: Any
    yn: Any
    dx: Any
    dy: Any
    diff: Any
    active_set: Any
    rcond: Any  # NaN: condition estimates are not ported (ROADMAP A4)


def make_step_result(it: Iterate, dx, dy, lb, ub, active_set) -> StepResult:
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
        rcond=float("nan"),
    )


class Factorization(NamedTuple):
    """Assembled and factored KKT system plus what the rhs needs."""

    fact: Any  # linear-solver factorization
    active: Any  # bool (n,)
    hess_shifted: Any  # H + lambda I, for the rhs condensation
    jac: Any
    inertia_ok: bool  # False forces a NaN step, hence a rejection


class StepSolverDef(NamedTuple):
    """Closures assembling, factoring and solving one formulation."""

    scaled: bool
    symmetric: bool
    hess_rho_is_runtime: bool
    factor: Any  # (func, H, J, active, rho) -> Factorization
    solve: Any  # (factorization, func, cur_it, rho) -> (dx, dy)


def step_solver_def(params: Params) -> StepSolverDef:
    if params.step_solver is not None:
        raise NotImplementedError(
            "custom step solvers (params.step_solver) are not yet ported (ROADMAP A5)"
        )
    if params.step_solver_type != StepSolverType.Symmetric:
        item = "A9" if params.step_solver_type == StepSolverType.Schur else "A5"
        raise NotImplementedError(
            f"step solver {params.step_solver_type.name} is not yet ported (ROADMAP {item})"
        )
    if params.report_rcond:
        raise NotImplementedError("report_rcond is not yet ported (ROADMAP A4)")
    lin = linear_solver(params.linear_solver_type, symmetric=True)
    return _symmetric_def(lin, params.inertia_correction)


def _symmetric_def(lin: LinearSolver, inertia_correction: bool) -> StepSolverDef:
    def factor(func: impl.StepFunc, H, J, active, rho):
        lamb = func.lamb
        n = H.shape[0]
        m = J.shape[0]
        eye_n = torch.eye(n, dtype=H.dtype, device=H.device)

        Hl = H + lamb * eye_n
        inact = ~active
        both_inact = inact[:, None] & inact[None, :]

        M11 = torch.where(both_inact, Hl, 0.0) + torch.diag(active.to(H.dtype))
        M12 = torch.where(inact[:, None], J.T, 0.0)
        fact = 1.0 / (1.0 + lamb * rho)
        M22 = -(lamb * fact) * torch.eye(m, dtype=H.dtype, device=H.device)

        mat = torch.cat(
            [torch.cat([M11, M12], dim=1), torch.cat([M12.T, M22], dim=1)], dim=0
        )
        factored = lin.factor(mat)

        inertia_ok = True
        if inertia_correction:
            # expect exactly m negative eigenvalues
            # (reference symmetric_step_solver.py:146-153)
            inertia_ok = int(lin.num_neg_eigvals(factored)) == m

        return Factorization(
            fact=factored, active=active, hess_shifted=Hl, jac=J, inertia_ok=inertia_ok
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        lamb = func.lamb
        dt = 1.0 / lamb
        pfact = 1.0 / (1.0 + lamb * rho)

        rx, ry = impl.value_at(func, it, rho, f.active)
        n = rx.shape[0]

        b0_full = torch.where(f.active, dt * rx, 0.0)
        # condensed rhs (reference symmetric_step_solver.py:79-94)
        rhs_x = torch.where(f.active, b0_full, rx - f.hess_shifted @ b0_full)
        rhs_y = pfact * ry - f.jac @ b0_full
        sol = lin.solve(f.fact, torch.cat([rhs_x, rhs_y]))

        dx = sol[:n]
        dy = pfact * (sol[n:] - rho * ry)
        if not f.inertia_ok:
            dx = torch.full_like(dx, float("nan"))
        return dx, dy

    return StepSolverDef(
        scaled=True,
        symmetric=True,
        hess_rho_is_runtime=False,
        factor=factor,
        solve=solve,
    )
