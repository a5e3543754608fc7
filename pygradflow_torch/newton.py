"""Semismooth Newton for the implicit-Euler subproblem (counterpart of
``pygradflow_tpu/newton.py``).

A Newton method is a pair of functions::

    init(orig_iterate, lamb, rho, tau, counters) -> (carry, counters)
    step(carry, cur_iterate, counters) -> (StepResult, carry, counters)

``tau`` is the active-set parameter of ``step.control.compute_tau`` (None
for ``ActiveSetType.Standard``).  The five variants of the reference
(``pygradflow/newton.py``):

- Simplified (the default): derivatives and active set frozen at the step
  origin, so ``init`` factors once per outer iteration and each ``step`` is
  one refined solve;
- Full: active set, derivatives and factor anew at every step;
- ActiveSet: derivatives frozen at the origin, the active set of the
  current iterate, a new factor at every step;
- FixedActiveSet: the active set given by ``params.fixed_active_set``, or
  derived from each step origin (``active_set_from_iterate``);
- Globalized: Full Newton with an Armijo line search on 1/2 ||F||^2; an
  exhausted search gives a NaN step, which the controller rejects.

Every variant serves one instance and a lane stack alike, and reads
nothing on the host.  Globalized's line search runs all
``linesearch_max_it`` trials, where the JAX package's ``lax.while_loop``
stops once its trial is accepted (on a lane stack: once no lane
searches); a search that has finished keeps its step and its counters.  A matrix-free step solver
factors from the iterate instead of the dense H and J (``_factorize``).
"""

from typing import Any, NamedTuple

import torch

from . import implicit_func as impl
from .eval import Counters, Fns
from .iterate import Iterate, aug_lag_deriv_x, aug_lag_deriv_xx, evaluate_iterate, iterate_eval_counts
from .params import NewtonType, Params
from .step.solvers import StepResult, StepSolverDef, make_step_result
from .util import dot, lanes, matvec, select


class NewtonCfg(NamedTuple):
    fns: Fns
    params: Params
    lb: Any
    ub: Any
    ssdef: StepSolverDef


def _eval_hess(cfg: NewtonCfg, it: Iterate, rho, counters: Counters):
    """The Standard solver takes the augmented Hessian at the runtime rho,
    the scaled step solvers the plain Lagrangian Hessian (reference
    ``scaled_step_solver.py:76-79``)."""
    h_rho = rho if cfg.ssdef.hess_rho_is_runtime else 0.0
    return aug_lag_deriv_xx(cfg.fns, it, h_rho), counters.add(lag_hess=1)


def _factorize(cfg: NewtonCfg, func, it: Iterate, active, rho, counters: Counters):
    """Assemble and factor the step matrix.  A matrix-free def receives the
    iterate, not H and J, and finds its blocks by jvp/hvp probes: one
    Hessian and one Jacobian evaluation are charged for them, as the JAX
    package charges them."""
    if cfg.ssdef.matrix_free:
        fact = cfg.ssdef.factor(func, it, active, rho)
        return fact, counters.add(lag_hess=1, cons_jac=1)
    H, counters = _eval_hess(cfg, it, rho, counters)
    return cfg.ssdef.factor(func, H, it.cons_jac, active, rho), counters


def _make_func(cfg: NewtonCfg, orig: Iterate, lamb):
    return impl.make_step_func(orig, lamb, cfg.lb, cfg.ub, scaled=cfg.ssdef.scaled)


def _result(cfg: NewtonCfg, it: Iterate, dx, dy, active, rcond=float("nan")) -> StepResult:
    return make_step_result(it, dx, dy, cfg.lb, cfg.ub, active, rcond)


def _simplified(cfg: NewtonCfg):
    def init(orig: Iterate, lamb, rho, tau, counters: Counters):
        func = _make_func(cfg, orig, lamb)
        active = impl.compute_active_set(func, orig, rho, tau, fns=cfg.fns)
        fact, counters = _factorize(cfg, func, orig, active, rho, counters)
        return (func, fact, rho), counters

    def step(carry, cur: Iterate, counters: Counters):
        func, fact, rho = carry
        dx, dy = cfg.ssdef.solve(fact, func, cur, rho)
        return _result(cfg, cur, dx, dy, fact.active, fact.rcond), carry, counters

    return init, step


def _full(cfg: NewtonCfg):
    def init(orig: Iterate, lamb, rho, tau, counters: Counters):
        return (_make_func(cfg, orig, lamb), rho, tau), counters

    def step(carry, cur: Iterate, counters: Counters):
        func, rho, tau = carry
        active = impl.compute_active_set(func, cur, rho, tau, fns=cfg.fns)
        fact, counters = _factorize(cfg, func, cur, active, rho, counters)
        dx, dy = cfg.ssdef.solve(fact, func, cur, rho)
        return _result(cfg, cur, dx, dy, active, fact.rcond), carry, counters

    return init, step


def _active_set(cfg: NewtonCfg):
    def init(orig: Iterate, lamb, rho, tau, counters: Counters):
        func = _make_func(cfg, orig, lamb)
        H = None  # matrix-free: the probes run at the frozen origin
        if not cfg.ssdef.matrix_free:
            H, counters = _eval_hess(cfg, orig, rho, counters)
        return (func, H, orig, rho, tau), counters

    def step(carry, cur: Iterate, counters: Counters):
        func, H, orig, rho, tau = carry
        active = impl.compute_active_set(func, cur, rho, tau, fns=cfg.fns)
        if cfg.ssdef.matrix_free:
            fact = cfg.ssdef.factor(func, orig, active, rho)
            counters = counters.add(lag_hess=1, cons_jac=1)
        else:
            fact = cfg.ssdef.factor(func, H, orig.cons_jac, active, rho)
        dx, dy = cfg.ssdef.solve(fact, func, cur, rho)
        return _result(cfg, cur, dx, dy, active, fact.rcond), carry, counters

    return init, step


def _half_norm_sq(rx, ry):
    return 0.5 * (dot(rx, rx) + dot(ry, ry))


def _globalized(cfg: NewtonCfg):
    fns = cfg.fns
    params = cfg.params
    m = fns.num_cons

    def init(orig: Iterate, lamb, rho, tau, counters: Counters):
        return (_make_func(cfg, orig, lamb), rho, tau), counters

    def step(carry, cur: Iterate, counters: Counters):
        func, rho, tau = carry
        orig = func.orig

        # as in the JAX package (newton.py:166-174): no fns for the active
        # set and the residual, and the direction from the residual at the
        # *origin* (reference newton.py:250)
        active = impl.compute_active_set(func, cur, rho, tau)
        H, counters = _eval_hess(cfg, cur, rho, counters)
        fact = cfg.ssdef.factor(func, H, cur.cons_jac, active, rho)
        dx0, dy0 = cfg.ssdef.solve(fact, func, orig, rho)

        rx, ry = impl.value_at(func, cur, rho)
        res_value = _half_norm_sq(rx, ry)

        # slope F'^T F (reference newton.py:263-272)
        fgrad = matvec(impl.deriv(func, cur.cons_jac, H, active).mT, torch.cat([rx, ry], dim=-1))
        n = dx0.shape[-1]
        inner = dot(fgrad[..., :n], dx0) + dot(fgrad[..., n:], dy0)

        alpha = torch.ones_like(res_value)
        dx, dy = dx0, dy0
        done = res_value <= params.newton_tol
        for _ in range(params.linesearch_max_it):
            searching = ~done
            cand = evaluate_iterate(fns, cur.x - dx, cur.y - dy)
            cres = _half_norm_sq(*impl.value_at(func, cand, rho))
            ok = (cres <= params.newton_tol) | (cres <= res_value + 1e-4 * alpha * inner)
            half = alpha * 0.5
            alpha = torch.where(searching & ~ok, half, alpha)
            dx = torch.where(lanes(searching & ~ok, 1), lanes(half, 1) * dx0, dx)
            dy = torch.where(lanes(searching & ~ok, 1), lanes(half, 1) * dy0, dy)
            counters_n = counters.add(**iterate_eval_counts(m))
            counters = select(searching, counters_n, counters)
            done = done | (searching & ok)

        # an exhausted search fails: a non-finite step forces rejection
        # (the reference raises "Line search failed to converge",
        # newton.py:297); the step is applied at the *origin* (newton.py:299)
        dx = torch.where(lanes(done, 1), dx, float("nan"))
        return _result(cfg, orig, dx, dy, active, fact.rcond), carry, counters

    return init, step


def active_set_from_iterate(fns: Fns, it: Iterate, lb, ub, rho=0.0, active_tol=1e-8):
    """Variables pinned at a bound by the sign of the augmented-Lagrangian
    gradient (counterpart of the reference's
    ``FixedActiveSetNewtonMethod.active_set_from_iterate``,
    ``newton.py:131-156``): a variable on (or beyond) a bound whose flow
    direction ``-d`` points outward stays clipped; every other is free."""
    x = it.x
    d = aug_lag_deriv_x(it, rho, fns=fns)
    pin_lower = (x <= lb + active_tol) & (d >= 0.0)
    pin_upper = (x >= ub - active_tol) & (d <= 0.0)
    return pin_lower | pin_upper


def _fixed_active_set(cfg: NewtonCfg):
    fixed = cfg.params.fixed_active_set

    def init(orig: Iterate, lamb, rho, tau, counters: Counters):
        func = _make_func(cfg, orig, lamb)
        if fixed is None:
            active = active_set_from_iterate(cfg.fns, orig, cfg.lb, cfg.ub, rho, cfg.params.active_tol)
        else:
            # the reference asserts both shape and dtype (newton.py:104-105)
            active = torch.as_tensor(fixed, device=orig.x.device)
            if active.dtype != torch.bool:
                raise ValueError(f"params.fixed_active_set must be a bool array (got dtype {active.dtype})")
            n = orig.x.shape[-1:]
            if active.shape != n:
                raise ValueError(
                    "params.fixed_active_set must cover the TRANSFORMED "
                    f"variables: expected shape {tuple(n)} (after scaling + "
                    f"slack transform), got {tuple(active.shape)}"
                )
            active = active.expand(orig.x.shape)
        return (func, active, rho), counters

    def step(carry, cur: Iterate, counters: Counters):
        func, active, rho = carry
        fact, counters = _factorize(cfg, func, cur, active, rho, counters)
        dx, dy = cfg.ssdef.solve(fact, func, cur, rho)
        return _result(cfg, cur, dx, dy, active, fact.rcond), carry, counters

    return init, step


def make_newton(cfg: NewtonCfg):
    """Factory keyed on NewtonType (reference ``newton.py:307-323``)."""
    nt = cfg.params.newton_type
    if cfg.ssdef.matrix_free and nt == NewtonType.Globalized:
        raise ValueError(
            "GlobalizedNewton needs the dense residual Jacobian for its "
            "line-search slope; unavailable with a matrix-free step solver"
        )
    variants = {
        NewtonType.Simplified: _simplified,
        NewtonType.Full: _full,
        NewtonType.ActiveSet: _active_set,
        NewtonType.FixedActiveSet: _fixed_active_set,
        NewtonType.Globalized: _globalized,
    }
    return variants[nt](cfg)
