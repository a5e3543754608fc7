"""Box-reduced step control (counterpart of
``pygradflow_tpu/step/box_control.py``, reference ``box_control.py``).

The duals are eliminated from the proximally regularised implicit-Euler
subproblem, which leaves the box-constrained problem

    min_x f(x) + rho/2 ||c(x)||^2 + lamb/2 (||x - x^||^2 + ||-c(x)/lamb - y^||^2)
    s.t.  lb <= x <= ub,

solved by the projected-Newton method of ``box_solver.py``.  Then
``y = y^ + c(x)/lamb``; the step is accepted, with lambda halved, when the
implicit-function residual is at most 1e-6, and rejected with lambda
doubled otherwise.  A failed box solve poisons x with NaN, so
``compute_step`` rejects the step; an unbounded subproblem's x is used as it
is.  No KKT matrix is factored: rcond stays NaN.  One body serves one
instance (``lamb`` a 0-dim tensor) and a lane stack (``lamb`` a (B,)
tensor).  The box solver's iterations end when no lane still iterates,
one host read each, so this controller keeps the eager loop.
"""

import torch

from .. import implicit_func as impl
from ..eval import Counters
from ..iterate import Iterate, evaluate_iterate, iterate_eval_counts
from ..util import dot, lanes, matvec
from .box_solver import BOX_OPTIMAL, BOX_UNBOUNDED, solve_box_constrained
from .control import ControlCfg, ControlResult

ACCEPT_TOL = 1e-6


def make_box_reduced(cfg: ControlCfg):
    params = cfg.params
    fns = cfg.fns
    lb, ub = cfg.lb, cfg.ub
    n = fns.num_vars

    def objective(orig: Iterate, x, lamb, rho):
        cons = fns.cons(x)
        dx = x - orig.x
        dy = -cons / lanes(lamb, 1) - orig.y
        return fns.obj(x) + 0.5 * rho * dot(cons, cons) + 0.5 * lamb * (dot(dx, dx) + dot(dy, dy))

    def gradient(orig: Iterate, x, lamb, rho):
        cons = fns.cons(x)
        factor = lanes(rho + 1.0 / lamb, 1) * cons + orig.y
        return fns.obj_grad(x) + lanes(lamb, 1) * (x - orig.x) + matvec(fns.cons_jac(x).mT, factor)

    def hessian(orig: Iterate, x, lamb, rho):
        jac = fns.cons_jac(x)
        cons_factor = 1.0 / lamb + rho
        H = fns.lag_hess(x, lanes(cons_factor, 1) * fns.cons(x) + orig.y)
        eye = torch.eye(n, dtype=H.dtype, device=H.device)
        return H + lanes(lamb, 2) * eye + lanes(cons_factor, 2) * (jac.mT @ jac)

    def step(orig: Iterate, lamb, rho, error_sum, counters: Counters) -> ControlResult:
        result = solve_box_constrained(
            orig.x,
            lambda x: objective(orig, x, lamb, rho),
            lambda x: gradient(orig, x, lamb, rho),
            lambda x: hessian(orig, x, lamb, rho),
            lb,
            ub,
            obj_lower=params.obj_lower_limit,
        )
        solver_ok = (result.status == BOX_OPTIMAL) | (result.status == BOX_UNBOUNDED)
        x = torch.where(lanes(solver_ok, 1), result.x, float("nan"))

        # the duals: y = y^ + c(x)/lamb (reference box_control.py:277-281)
        y = orig.y + fns.cons(x) / lanes(lamb, 1)
        next_it = evaluate_iterate(fns, x, y)
        counters = counters.add(**iterate_eval_counts(cfg.m))

        func = impl.make_step_func(orig, lamb, lb, ub, scaled=False)
        accepted = impl.value_norm(func, next_it, rho) <= ACCEPT_TOL
        lamb_n = torch.where(accepted, 0.5 * lamb, 2.0 * lamb)
        active = impl.compute_active_set(func, next_it, rho)
        return ControlResult(
            next_it, lamb_n, accepted, error_sum, active, counters, float("nan"), (next_it.x, next_it.y)
        )

    return step
