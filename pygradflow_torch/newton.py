"""Semismooth Newton for the implicit-Euler subproblem (counterpart of
``pygradflow_tpu/newton.py``).

A Newton method is a pair of functions::

    init(orig_iterate, lamb, rho, counters) -> (carry, counters)
    step(carry, cur_iterate, counters) -> (StepResult, carry, counters)

Simplified Newton (the default) is ported: derivatives and active set are
frozen at the step origin, so ``init`` factors once per outer iteration and
each ``step`` is one refined solve.
"""

from typing import Any, NamedTuple

from . import implicit_func as impl
from .eval import Counters, Fns
from .iterate import Iterate, aug_lag_deriv_xx
from .params import NewtonType, Params
from .step.solvers import StepResult, StepSolverDef, make_step_result


class NewtonCfg(NamedTuple):
    fns: Fns
    params: Params
    lb: Any
    ub: Any
    ssdef: StepSolverDef


def _eval_hess(cfg: NewtonCfg, it: Iterate, rho, counters: Counters):
    """The scaled step solvers take the plain Lagrangian Hessian
    (reference ``scaled_step_solver.py:76-79``)."""
    h_rho = rho if cfg.ssdef.hess_rho_is_runtime else 0.0
    return aug_lag_deriv_xx(cfg.fns, it, h_rho), counters.add(lag_hess=1)


def _simplified(cfg: NewtonCfg):
    def init(orig: Iterate, lamb, rho, counters: Counters):
        func = impl.make_step_func(orig, lamb, cfg.lb, cfg.ub, scaled=cfg.ssdef.scaled)
        active = impl.compute_active_set(func, orig, rho)
        H, counters = _eval_hess(cfg, orig, rho, counters)
        fact = cfg.ssdef.factor(func, H, orig.cons_jac, active, rho)
        return (func, fact, rho), counters

    def step(carry, cur: Iterate, counters: Counters) -> tuple:
        func, fact, rho = carry
        dx, dy = cfg.ssdef.solve(fact, func, cur, rho)
        result: StepResult = make_step_result(cur, dx, dy, cfg.lb, cfg.ub, fact.active)
        return result, carry, counters

    return init, step


def make_newton(cfg: NewtonCfg):
    """Factory keyed on NewtonType (reference ``newton.py:307-323``)."""
    nt = cfg.params.newton_type
    if nt != NewtonType.Simplified:
        raise NotImplementedError(f"Newton method {nt.name} is not yet ported (ROADMAP A5)")
    return _simplified(cfg)
