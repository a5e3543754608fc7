"""Optimizing step control (counterpart of
``pygradflow_tpu/step/opti_control.py``, reference ``opti_control.py``).

The proximal implicit-Euler subproblem is solved by the primal-dual
interior point of ``ip_solver.py``.  A converged solve is accepted with
lambda halved; otherwise x is poisoned with NaN, so ``compute_step``
rejects the step and doubles lambda.  The interior point's KKT matrix
always goes to the f64 LDL^T tier, whatever ``params.linear_solver_type``
says (the reference hands the subproblem to Ipopt, whose factorization is
its own), and rcond stays NaN.  One body serves one instance and a lane
stack.
"""

import torch

from .. import implicit_func as impl
from ..eval import Counters
from ..iterate import Iterate, evaluate_iterate, iterate_eval_counts
from ..linalg import LinearSolverType, linear_solver
from ..util import lanes
from .control import ControlCfg, ControlResult
from .ip_solver import IP_MAX_IT, solve_ip  # noqa: F401


def make_optimizing(cfg: ControlCfg, lanes_form: bool = False):
    fns = cfg.fns
    lb, ub = cfg.lb, cfg.ub
    lin = linear_solver(LinearSolverType.LDLT, symmetric=True)

    def factor_solve(K, b):
        return lin.solve(lin.factor(K), b)

    def step(orig: Iterate, lamb, rho, error_sum, counters: Counters) -> ControlResult:
        result = solve_ip(fns, factor_solve, orig.x, orig.y, lamb, rho, lb, ub)
        converged, its = result.converged, result.iterations
        if not lanes_form:
            converged, its = bool(converged), int(its)

        # one (gradient, constraints, Jacobian) set per interior-point
        # iteration and one for its start, one Hessian per iteration
        counters = counters.add(obj_grad=its + 1, cons=its + 1, cons_jac=its + 1, lag_hess=its)
        x = torch.where(lanes(torch.as_tensor(converged, device=result.x.device), 1), result.x, float("nan"))
        next_it = evaluate_iterate(fns, x, result.nu)
        counters = counters.add(**iterate_eval_counts(cfg.m))

        if lanes_form:
            lamb_n = torch.where(converged, 0.5 * lamb, 2.0 * lamb)
        else:
            lamb_n = 0.5 * lamb if converged else 2.0 * lamb
        func = impl.make_step_func(orig, lamb, lb, ub, scaled=False)
        active = impl.compute_active_set(func, next_it, rho)
        return ControlResult(
            next_it, lamb_n, converged, error_sum, active, counters, float("nan"), (next_it.x, next_it.y)
        )

    return step
