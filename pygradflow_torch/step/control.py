"""Step-size control: accept or reject a step and adapt lambda = 1/dt
(counterpart of ``pygradflow_tpu/step/control.py``).

The controllers DistanceRatio (the default), ResiduumRatio, Exact and
Fixed, each in two forms; BoxReduced (``box_control.py``) and Optimizing
(``opti_control.py``) likewise.  For one instance, where the JAX package computes
both branches under ``lax.cond``/``jnp.where`` and masks, this eager port
branches in Python on the same conditions in the same order, which takes
the same decisions.  For a lane stack (``lanes``) it does what the JAX body
does under ``vmap``: every lane computes every branch and ``torch.where``
picks each lane's, so each lane takes the decisions of the single form.
Exact's inner Newton loop stops for one instance when it converges or
fails (one host read per inner step).  On a lane stack it reads nothing on
the host: it runs all ``newton_max_it`` steps, where the JAX package's
``lax.while_loop`` stops once no lane iterates, and a lane that has
finished keeps its iterate, counters and first candidate.

The active-set parameter tau (``compute_tau``) follows the reference
heuristics (``step/newton_control.py:40-88``): none for Standard, a given
value for Explicit or from ``params.active_set_method``, and the smallest
or largest ratio at which the gradient flow reaches a bound.

The PI controller on log(theta) follows the reference LogController
(``pygradflow/controller.py:29-77``): on acceptance
``lamb <- max(lamb_min, lamb / exp(K_P e + K_I sum_e))`` with
``e = log(theta_ref) - log(theta)``; on rejection ``lamb *= lamb_inc`` and
a positive integral term resets.

Error recovery (reference ``step_control.py:64-107``): a broken
factorization or a non-finite evaluation shows up as non-finite values in
the candidate; :func:`compute_step` turns that into a rejected step with
doubled lambda.
"""

import logging
import math
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from .. import implicit_func as impl
from ..display import inner_display
from ..eval import Counters
from ..iterate import Iterate, aug_lag_deriv_x, evaluate_iterate, iterate_eval_counts
from ..log import logger
from ..newton import NewtonCfg, make_newton
from ..params import ActiveSetType, Params, StepControlType
from ..util import select
from .solvers import step_solver_def


class ControlResult(NamedTuple):
    iterate: Iterate  # evaluated candidate iterate
    lamb: float  # next lambda
    accepted: bool
    error_sum: float  # PI integral state
    active_set: Any  # bool (n,) from the last Newton step
    counters: Counters
    rcond: Any  # estimate from the last factorization (a float NaN when off)
    # (x, y) of the first evaluated inner candidate, for the eval diagnosis
    first_point: Any


class ControlCfg(NamedTuple):
    fns: Any
    params: Params
    lb: Any
    ub: Any
    newton_init: Any
    newton_step: Any
    m: int


def make_control_cfg(fns, params: Params, lb, ub) -> ControlCfg:
    ssdef = step_solver_def(params, fns)
    ncfg = NewtonCfg(fns=fns, params=params, lb=lb, ub=ub, ssdef=ssdef)
    newton_init, newton_step = make_newton(ncfg)
    return ControlCfg(
        fns=fns,
        params=params,
        lb=lb,
        ub=ub,
        newton_init=newton_init,
        newton_step=newton_step,
        m=fns.num_cons,
    )


def _tau_vals(cfg: ControlCfg, it: Iterate, rho):
    """Per variable, the flow time to its bound along the gradient (-1 where
    the gradient is close to 0)."""
    x = it.x
    g = aug_lag_deriv_x(it, rho, cfg.fns)
    zero_g = torch.isclose(g, torch.zeros_like(g), rtol=1e-5, atol=1e-8)
    pos_g = (g > 0.0) & ~zero_g
    neg_g = (g < 0.0) & ~zero_g
    safe_g = torch.where(zero_g, 1.0, g)
    tau = torch.full_like(x, -1.0)
    tau = torch.where(pos_g, (x - cfg.lb) / safe_g, tau)
    return torch.where(neg_g, (cfg.ub - x) / -safe_g, tau)


def compute_tau(cfg: ControlCfg, it: Iterate, lamb, rho):
    """tau of the active-set projection point (reference
    ``step/newton_control.py:40-88``): ``None`` for
    ``ActiveSetType.Standard``; a float, or a tensor with one value per
    lane.  ``params.active_set_method(iterate, lamb, rho)`` is written for
    one instance; on a lane stack it is mapped over the lanes
    (``torch.func.vmap``), as the JAX package's vmap calls it."""
    params = cfg.params
    ast = params.active_set_type
    if ast == ActiveSetType.Explicit:
        if params.active_set_tau is None:
            raise ValueError("ActiveSetType.Explicit requires params.active_set_tau")
        return params.active_set_tau
    method = params.active_set_method
    if method is not None:
        if it.x.ndim == 1:
            return method(it, lamb, rho)
        return vmap(lambda *a: torch.as_tensor(method(*a), dtype=it.x.dtype))(it, lamb, rho)
    if ast == ActiveSetType.Standard:
        return None

    tau_vals = _tau_vals(cfg, it, rho)
    if ast == ActiveSetType.SmallestActiveSet:
        pos = tau_vals > 0
        min_tau = torch.amin(torch.where(pos, tau_vals, torch.inf), dim=-1)
        return torch.where(pos.any(dim=-1), 0.5 * min_tau, 1.0)
    return torch.clamp(torch.amax(tau_vals, dim=-1), min=1.0)  # LargestActiveSet


def _pi_accept(params: Params, lamb, theta, error_sum):
    """The PI update of one accepted step; the arithmetic rounds to the
    solve's precision (``params.scalar_type``) at each operation."""
    f = params.scalar_type
    with np.errstate(over="ignore", divide="ignore"):
        error = f(np.log(params.theta_ref)) - np.log(f(theta))
        es_n = f(error_sum) + error
        lamb_mod = np.exp(f(params.K_P) * error + f(params.K_I) * es_n)
        lamb_n = np.maximum(f(params.lamb_min), f(lamb) / lamb_mod)
    return float(lamb_n), float(es_n)


def _pi_reject(params: Params, lamb, error_sum):
    f = params.scalar_type
    return float(f(lamb) * f(params.lamb_inc)), (0.0 if error_sum > 0.0 else error_sum)


def _pi_lanes(params: Params, lamb, theta, error_sum, accepted):
    """The PI update of every lane, accepted or rejected."""
    error = math.log(params.theta_ref) - torch.log(torch.clamp(theta, min=1e-300))
    es_acc = error_sum + error
    lamb_acc = torch.clamp(
        lamb / torch.exp(params.K_P * error + params.K_I * es_acc), min=params.lamb_min
    )
    lamb_n = torch.where(accepted, lamb_acc, lamb * params.lamb_inc)
    es_n = torch.where(accepted, es_acc, torch.where(error_sum > 0.0, 0.0, error_sum))
    return lamb_n, es_n


def _reduced_lamb(params: Params, lamb):
    """lambda after a first Newton step that converged."""
    if torch.is_tensor(lamb):
        return torch.clamp(lamb * params.lamb_red, min=params.lamb_min)
    f = params.scalar_type
    return float(np.maximum(f(lamb) * f(params.lamb_red), f(params.lamb_min)))


def _inner_debug(cfg: ControlCfg, lanes: bool = False):
    """The per-inner-Newton-iteration DEBUG rows (reference
    ``step_control.py:109-120`` and ``display.py:307-315``), or ``None``.
    The gate, ``params.display`` and a log level of DEBUG or below, is
    decided once, when the controller is built: with it off the loop does
    no display work.  Each row reads (residual, step distance, active-set
    size) on the host.  A lane stack shows no rows (``BatchedSolver``
    refuses ``display``)."""
    if lanes or not cfg.params.display or logger.getEffectiveLevel() > logging.DEBUG:
        return None

    disp = inner_display(cfg.params)

    def emit(i, residuum, dist, active_set):
        res, dist, active = torch.stack(
            [torch.as_tensor(v, dtype=torch.float64, device=active_set.device)
             for v in (residuum, dist, active_set.sum())]
        ).tolist()
        disp.row({"inner": int(i), "residuum": res, "dist": dist, "active": int(active)})

    return emit


def _evaluate(cfg: ControlCfg, xn, yn, counters: Counters):
    it = evaluate_iterate(cfg.fns, xn, yn)
    return it, counters.add(**iterate_eval_counts(cfg.m))


def _start(cfg: ControlCfg, orig: Iterate, lamb, rho, counters):
    """tau, the Newton method's carry and the unscaled implicit function,
    with which the controllers measure residuals (reference
    ``distance_ratio_control.py:28``)."""
    tau = compute_tau(cfg, orig, lamb, rho)
    carry, counters = cfg.newton_init(orig, lamb, rho, tau, counters)
    func = impl.make_step_func(orig, lamb, cfg.lb, cfg.ub, scaled=False)
    return carry, func, counters


def _distance_ratio(cfg: ControlCfg):
    params = cfg.params
    emit = _inner_debug(cfg)

    def step(orig: Iterate, lamb, rho, error_sum, counters) -> ControlResult:
        carry, func, counters = _start(cfg, orig, lamb, rho, counters)

        step1, carry, counters = cfg.newton_step(carry, orig, counters)
        mid_it, counters = _evaluate(cfg, step1.xn, step1.yn, counters)
        mid_norm, diff1 = torch.stack(
            [impl.value_norm(func, mid_it, rho, fns=cfg.fns), step1.diff]
        ).tolist()
        first = (mid_it.x, mid_it.y)
        if emit is not None:
            emit(0, mid_norm, diff1, step1.active_set)

        conv1 = mid_norm <= params.newton_tol
        zero1 = diff1 == 0.0
        if conv1 or zero1:
            lamb_n = _reduced_lamb(params, lamb) if conv1 else lamb
            return ControlResult(
                mid_it, lamb_n, True, error_sum, step1.active_set, counters, step1.rcond, first
            )

        step2, _, counters = cfg.newton_step(carry, mid_it, counters)
        fin_it, counters = _evaluate(cfg, step2.xn, step2.yn, counters)
        diff2 = step2.diff.item()
        if emit is not None:
            emit(1, impl.value_norm(func, fin_it, rho, fns=cfg.fns), diff2, step2.active_set)

        if diff2 == 0.0:  # zero second step: accept at unchanged lambda
            return ControlResult(
                fin_it, lamb, True, error_sum, step2.active_set, counters, step2.rcond, first
            )

        f = params.scalar_type
        theta = f(diff2) / f(diff1)
        accepted = bool(theta <= f(params.theta_max))
        if accepted:
            lamb_n, es_n = _pi_accept(params, lamb, np.maximum(theta, f(1e-300)), error_sum)
        else:
            lamb_n, es_n = _pi_reject(params, lamb, error_sum)
        return ControlResult(
            fin_it, lamb_n, accepted, es_n, step2.active_set, counters, step2.rcond, first
        )

    return step


def _distance_ratio_lanes(cfg: ControlCfg):
    """DistanceRatio on a lane stack: ``lamb``, ``rho`` and ``error_sum``
    are (B,) tensors, ``counters`` holds (B,) tensors."""
    params = cfg.params

    def step(orig: Iterate, lamb, rho, error_sum, counters) -> ControlResult:
        carry, func, counters = _start(cfg, orig, lamb, rho, counters)

        step1, carry, counters = cfg.newton_step(carry, orig, counters)
        mid_it, counters = _evaluate(cfg, step1.xn, step1.yn, counters)
        conv1 = impl.value_norm(func, mid_it, rho, fns=cfg.fns) <= params.newton_tol
        early = conv1 | (step1.diff == 0.0)
        lamb_early = torch.where(conv1, _reduced_lamb(params, lamb), lamb)

        step2, _, counters2 = cfg.newton_step(carry, mid_it, counters)
        fin_it, counters2 = _evaluate(cfg, step2.xn, step2.yn, counters2)
        zero2 = step2.diff == 0.0
        theta = step2.diff / torch.where(step1.diff == 0.0, 1.0, step1.diff)
        accepted = theta <= params.theta_max
        # accept, reject, or a zero second step, accepted at unchanged lambda
        lamb_full, es_full = _pi_lanes(params, lamb, theta, error_sum, accepted)
        lamb_full = torch.where(zero2, lamb, lamb_full)
        es_full = torch.where(zero2, error_sum, es_full)

        rcond = step1.rcond
        if torch.is_tensor(rcond):
            rcond = torch.where(early, step1.rcond, step2.rcond)
        return ControlResult(
            iterate=select(early, mid_it, fin_it),
            lamb=torch.where(early, lamb_early, lamb_full),
            accepted=early | accepted | zero2,
            error_sum=torch.where(early, error_sum, es_full),
            active_set=step1.active_set,
            counters=select(early, counters, counters2),
            rcond=rcond,
            first_point=(mid_it.x, mid_it.y),
        )

    return step


def _residuum_ratio(cfg: ControlCfg, lanes: bool):
    """One Newton step; theta is the ratio of the residual after it to the
    residual at the origin (reference ``residuum_ratio_control.py``).  One
    body on tensors for both forms; one instance reads its decision with
    one host read, its lambda and PI sum going in as 0-dim CPU tensors."""
    params = cfg.params
    emit = _inner_debug(cfg, lanes)

    def step(orig: Iterate, lamb, rho, error_sum, counters) -> ControlResult:
        carry, func, counters = _start(cfg, orig, lamb, rho, counters)
        step1, _, counters = cfg.newton_step(carry, orig, counters)
        mid_it, counters = _evaluate(cfg, step1.xn, step1.yn, counters)
        mid_norm = impl.value_norm(func, mid_it, rho, fns=cfg.fns)
        if emit is not None:
            emit(0, mid_norm, step1.diff, step1.active_set)
        orig_norm = impl.value_norm(func, orig, rho, fns=cfg.fns)
        if not lanes:
            lamb, error_sum = (torch.tensor(v, dtype=mid_norm.dtype) for v in (lamb, error_sum))

        conv1 = mid_norm <= params.newton_tol
        theta = mid_norm / torch.where(orig_norm == 0.0, 1.0, orig_norm)
        accepted = theta <= params.theta_max
        lamb_n, es_n = _pi_lanes(params, lamb, theta, error_sum, accepted)
        # a first step that converged: accept with reduced lambda
        lamb_n = torch.where(conv1, _reduced_lamb(params, lamb), lamb_n)
        accepted = accepted | conv1
        es_n = torch.where(conv1, error_sum, es_n)
        if not lanes:
            lamb_n, accepted, es_n = torch.stack([lamb_n, accepted.to(lamb_n.dtype), es_n]).tolist()
            accepted = bool(accepted)
        return ControlResult(
            mid_it, lamb_n, accepted, es_n, step1.active_set, counters, step1.rcond, (mid_it.x, mid_it.y)
        )

    return step


def _exact(cfg: ControlCfg, lanes: bool):
    """Newton to convergence, at most ``newton_max_it`` steps: halve lambda
    on success, double it on failure, a residual contracting by less than
    ``rate_bound`` per step or non-finite (reference ``exact_control.py``)."""
    params = cfg.params
    rate_bound = 0.5
    emit = _inner_debug(cfg, lanes)

    def step(orig: Iterate, lamb, rho, error_sum, counters) -> ControlResult:
        carry, func, counters = _start(cfg, orig, lamb, rho, counters)
        val = impl.value_norm(func, orig, rho, fns=cfg.fns)
        state = torch.zeros_like(val, dtype=torch.int64)  # 0 iterating, 1 converged, 2 failed
        it, active, first = orig, torch.zeros_like(orig.x, dtype=torch.bool), (orig.x, orig.y)
        rcond = float("nan")

        for i in range(params.newton_max_it):
            running = state == 0
            if not lanes and not bool(running):
                break
            step_i, carry, counters_n = cfg.newton_step(carry, it, counters)
            next_it, counters_n = _evaluate(cfg, step_i.xn, step_i.yn, counters_n)
            next_val = impl.value_norm(func, next_it, rho, fns=cfg.fns)
            if emit is not None:
                emit(i, next_val, step_i.diff, step_i.active_set)
            converged = next_val <= params.newton_tol
            rate_bad = next_val / torch.where(val == 0.0, 1.0, val) > rate_bound
            bad = (~converged & rate_bad) | ~torch.isfinite(next_val)
            state_n = torch.where(converged, 1, torch.where(bad, 2, 0))
            if i == 0:
                first = (next_it.x, next_it.y)
            if lanes:
                it = select(running, next_it, it)
                counters = select(running, counters_n, counters)
                active = select(running, step_i.active_set, active)
                val = torch.where(running, next_val, val)
                state = torch.where(running, state_n, state)
                if torch.is_tensor(step_i.rcond):
                    rcond = torch.where(running, step_i.rcond, rcond)
            else:
                it, counters, active, val, state = next_it, counters_n, step_i.active_set, next_val, state_n
                rcond = step_i.rcond

        success = state == 1
        if lanes:
            lamb_n = torch.where(success, 0.5 * lamb, 2.0 * lamb)
        else:
            success = bool(success)
            lamb_n = 0.5 * lamb if success else 2.0 * lamb
        return ControlResult(it, lamb_n, success, error_sum, active, counters, rcond, first)

    return step


def _fixed(cfg: ControlCfg, lanes: bool):
    """One Newton step, always accepted, lambda back at ``lamb_init``
    (reference ``fixed_control.py``)."""
    params = cfg.params
    emit = _inner_debug(cfg, lanes)

    def step(orig: Iterate, lamb, rho, error_sum, counters) -> ControlResult:
        carry, func, counters = _start(cfg, orig, lamb, rho, counters)
        step1, _, counters = cfg.newton_step(carry, orig, counters)
        mid_it, counters = _evaluate(cfg, step1.xn, step1.yn, counters)
        if emit is not None:
            emit(0, impl.value_norm(func, mid_it, rho, fns=cfg.fns), step1.diff, step1.active_set)
        lamb_n, accepted = float(params.scalar_type(params.lamb_init)), True
        if lanes:
            lamb_n = torch.full_like(lamb, params.lamb_init)
            accepted = torch.ones_like(lamb, dtype=torch.bool)
        return ControlResult(
            mid_it, lamb_n, accepted, error_sum, step1.active_set, counters, step1.rcond, (mid_it.x, mid_it.y)
        )

    return step


def make_controller(cfg: ControlCfg, lanes: bool = False):
    """Factory keyed on StepControlType (reference ``step/step_control.py:123-150``);
    ``lanes`` selects the form for a lane stack."""
    sct = cfg.params.step_control_type
    if sct == StepControlType.DistanceRatio:
        return _distance_ratio_lanes(cfg) if lanes else _distance_ratio(cfg)
    if sct == StepControlType.ResiduumRatio:
        return _residuum_ratio(cfg, lanes)
    if sct == StepControlType.Exact:
        return _exact(cfg, lanes)
    if sct == StepControlType.Fixed:
        return _fixed(cfg, lanes)
    if sct == StepControlType.BoxReduced:
        from .box_control import make_box_reduced

        return make_box_reduced(cfg, lanes)
    if sct == StepControlType.Optimizing:
        from .opti_control import make_optimizing

        return make_optimizing(cfg, lanes)
    raise ValueError(f"Unknown step control type {sct}")


def _iterate_finite(it: Iterate) -> bool:
    leaves = [it.x, it.y, it.obj, it.obj_grad, it.cons, it.cons_jac]
    return bool(torch.stack([torch.isfinite(leaf).all() for leaf in leaves]).all())


def compute_step_lanes(cfg: ControlCfg, controller, orig: Iterate, lamb, rho, error_sum, counters):
    """:func:`compute_step` on a lane stack: each lane whose candidate or
    lambda is not finite gets a rejected step with doubled lambda."""
    res = controller(orig, lamb, rho, error_sum, counters)
    batch = lamb.shape[0]
    ok = torch.isfinite(res.lamb)
    for leaf in res.iterate:
        ok = ok & torch.isfinite(leaf).reshape(batch, -1).all(dim=-1)
    return res._replace(
        iterate=select(ok, res.iterate, orig),
        lamb=torch.where(ok, res.lamb, 2.0 * lamb),
        accepted=res.accepted & ok,
        error_sum=torch.where(ok, res.error_sum, error_sum),
    )


class ComputedStep(NamedTuple):
    """The (recovered) control result plus the failure evidence the
    solver's eval diagnosis needs."""

    ctrl: ControlResult
    eval_ok: bool  # candidate iterate and lambda were finite
    first_x: Any  # first evaluated inner candidate (before recovery)
    first_y: Any
    cand_x: Any  # final candidate (before recovery)
    cand_y: Any


def compute_step(cfg: ControlCfg, controller, orig: Iterate, lamb, rho, error_sum, counters):
    """Run the controller; a non-finite candidate (broken factorization,
    failed evaluation) becomes a rejected step with doubled lambda."""
    res = controller(orig, lamb, rho, error_sum, counters)
    ok = _iterate_finite(res.iterate) and np.isfinite(res.lamb)
    ctrl = res
    if not ok:
        ctrl = ControlResult(
            iterate=orig,
            lamb=2.0 * lamb,
            accepted=False,
            error_sum=error_sum,
            active_set=res.active_set,
            counters=res.counters,
            rcond=res.rcond,
            first_point=res.first_point,
        )
    return ComputedStep(
        ctrl=ctrl,
        eval_ok=ok,
        first_x=res.first_point[0],
        first_y=res.first_point[1],
        cand_x=res.iterate.x,
        cand_y=res.iterate.y,
    )
