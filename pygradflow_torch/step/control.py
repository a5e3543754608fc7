"""Step-size control: accept or reject a step and adapt lambda = 1/dt
(counterpart of ``pygradflow_tpu/step/control.py``).

The controllers DistanceRatio (the default), ResiduumRatio, Exact and
Fixed; BoxReduced (``box_control.py``) and Optimizing (``opti_control.py``)
likewise.  One body serves one instance and a lane stack: lambda, rho and
the PI sum are 0-dim tensors of ``params.dtype`` for one instance and (B,)
tensors for a lane stack, and every decision is a ``torch.where``, as the
JAX body's ``jnp.where`` under ``vmap``, so an iteration reads nothing on
the host and can be captured in a CUDA graph.  Where the JAX package's
one instance takes one branch of ``lax.cond``, both are computed here and
the outcome picked.  Exact's inner Newton loop runs all ``newton_max_it``
steps, where the JAX package's ``lax.while_loop`` stops once it converges
or fails, and a finished loop keeps its iterate, counters and first
candidate.

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
    lamb: Any  # next lambda, a 0-dim or (B,) tensor
    accepted: Any  # bool tensor
    error_sum: Any  # PI integral state
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


def _pi(params: Params, lamb, theta, error_sum, accepted):
    """The PI update, accepted or rejected, on 0-dim tensors (one
    instance) or (B,) tensors (a lane stack)."""
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
    return torch.clamp(lamb * params.lamb_red, min=params.lamb_min)


def _inner_debug(cfg: ControlCfg):
    """The per-inner-Newton-iteration DEBUG rows (reference
    ``step_control.py:109-120`` and ``display.py:307-315``), or ``None``.
    The gate, ``params.display`` and a log level of DEBUG or below, is
    decided once, when the controller is built: with it off the loop does
    no display work.  Each row reads (residual, step distance, active-set
    size) on the host, so a display keeps the eager loop; a lane stack
    shows none (``BatchedSolver`` refuses ``display``)."""
    if not cfg.params.display or logger.getEffectiveLevel() > logging.DEBUG:
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
    """Two Newton steps; theta is the ratio of the second step's length to
    the first's (reference ``distance_ratio_control.py``).  ``lamb``,
    ``rho`` and ``error_sum`` are 0-dim tensors (one instance) or (B,)
    tensors (a lane stack).  Both steps are always computed and
    ``torch.where`` picks the outcome, where the JAX package's one instance
    takes ``lax.cond``: a first step that converged or vanished is
    accepted at once."""
    params = cfg.params
    emit = _inner_debug(cfg)

    def step(orig: Iterate, lamb, rho, error_sum, counters) -> ControlResult:
        carry, func, counters = _start(cfg, orig, lamb, rho, counters)

        step1, carry, counters = cfg.newton_step(carry, orig, counters)
        mid_it, counters = _evaluate(cfg, step1.xn, step1.yn, counters)
        mid_norm = impl.value_norm(func, mid_it, rho, fns=cfg.fns)
        if emit is not None:
            emit(0, mid_norm, step1.diff, step1.active_set)
        conv1 = mid_norm <= params.newton_tol
        early = conv1 | (step1.diff == 0.0)
        lamb_early = torch.where(conv1, _reduced_lamb(params, lamb), lamb)

        step2, _, counters2 = cfg.newton_step(carry, mid_it, counters)
        fin_it, counters2 = _evaluate(cfg, step2.xn, step2.yn, counters2)
        if emit is not None and not bool(early):
            emit(1, impl.value_norm(func, fin_it, rho, fns=cfg.fns), step2.diff, step2.active_set)
        zero2 = step2.diff == 0.0
        theta = step2.diff / torch.where(step1.diff == 0.0, 1.0, step1.diff)
        accepted = theta <= params.theta_max
        # accept, reject, or a zero second step, accepted at unchanged lambda
        lamb_full, es_full = _pi(params, lamb, theta, error_sum, accepted)
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
            active_set=select(early, step1.active_set, step2.active_set),
            counters=select(early, counters, counters2),
            rcond=rcond,
            first_point=(mid_it.x, mid_it.y),
        )

    return step


def _residuum_ratio(cfg: ControlCfg):
    """One Newton step; theta is the ratio of the residual after it to the
    residual at the origin (reference ``residuum_ratio_control.py``)."""
    params = cfg.params
    emit = _inner_debug(cfg)

    def step(orig: Iterate, lamb, rho, error_sum, counters) -> ControlResult:
        carry, func, counters = _start(cfg, orig, lamb, rho, counters)
        step1, _, counters = cfg.newton_step(carry, orig, counters)
        mid_it, counters = _evaluate(cfg, step1.xn, step1.yn, counters)
        mid_norm = impl.value_norm(func, mid_it, rho, fns=cfg.fns)
        if emit is not None:
            emit(0, mid_norm, step1.diff, step1.active_set)
        orig_norm = impl.value_norm(func, orig, rho, fns=cfg.fns)

        conv1 = mid_norm <= params.newton_tol
        theta = mid_norm / torch.where(orig_norm == 0.0, 1.0, orig_norm)
        accepted = theta <= params.theta_max
        lamb_n, es_n = _pi(params, lamb, theta, error_sum, accepted)
        # a first step that converged: accept with reduced lambda
        lamb_n = torch.where(conv1, _reduced_lamb(params, lamb), lamb_n)
        accepted = accepted | conv1
        es_n = torch.where(conv1, error_sum, es_n)
        return ControlResult(
            mid_it, lamb_n, accepted, es_n, step1.active_set, counters, step1.rcond, (mid_it.x, mid_it.y)
        )

    return step


def _exact(cfg: ControlCfg):
    """Newton to convergence, at most ``newton_max_it`` steps: halve lambda
    on success, double it on failure, a residual contracting by less than
    ``rate_bound`` per step or non-finite (reference ``exact_control.py``).
    All ``newton_max_it`` steps run with no host read; a step after the
    loop has ended leaves iterate, counters and active set as they were,
    as the JAX package's ``lax.while_loop`` does by stopping."""
    params = cfg.params
    rate_bound = 0.5
    emit = _inner_debug(cfg)

    def step(orig: Iterate, lamb, rho, error_sum, counters) -> ControlResult:
        carry, func, counters = _start(cfg, orig, lamb, rho, counters)
        val = impl.value_norm(func, orig, rho, fns=cfg.fns)
        state = torch.zeros_like(val, dtype=torch.int64)  # 0 iterating, 1 converged, 2 failed
        it, active, first = orig, torch.zeros_like(orig.x, dtype=torch.bool), (orig.x, orig.y)
        rcond = float("nan")

        for i in range(params.newton_max_it):
            running = state == 0
            step_i, carry, counters_n = cfg.newton_step(carry, it, counters)
            next_it, counters_n = _evaluate(cfg, step_i.xn, step_i.yn, counters_n)
            next_val = impl.value_norm(func, next_it, rho, fns=cfg.fns)
            if emit is not None and bool(running):
                emit(i, next_val, step_i.diff, step_i.active_set)
            converged = next_val <= params.newton_tol
            rate_bad = next_val / torch.where(val == 0.0, 1.0, val) > rate_bound
            bad = (~converged & rate_bad) | ~torch.isfinite(next_val)
            state_n = torch.where(converged, 1, torch.where(bad, 2, 0))
            if i == 0:
                first = (next_it.x, next_it.y)
            it = select(running, next_it, it)
            counters = select(running, counters_n, counters)
            active = select(running, step_i.active_set, active)
            val = torch.where(running, next_val, val)
            state = torch.where(running, state_n, state)
            if torch.is_tensor(step_i.rcond):
                rcond = torch.where(running, step_i.rcond, rcond)

        success = state == 1
        lamb_n = torch.where(success, 0.5 * lamb, 2.0 * lamb)
        return ControlResult(it, lamb_n, success, error_sum, active, counters, rcond, first)

    return step


def _fixed(cfg: ControlCfg):
    """One Newton step, always accepted, lambda back at ``lamb_init``
    (reference ``fixed_control.py``)."""
    params = cfg.params
    emit = _inner_debug(cfg)

    def step(orig: Iterate, lamb, rho, error_sum, counters) -> ControlResult:
        carry, func, counters = _start(cfg, orig, lamb, rho, counters)
        step1, _, counters = cfg.newton_step(carry, orig, counters)
        mid_it, counters = _evaluate(cfg, step1.xn, step1.yn, counters)
        if emit is not None:
            emit(0, impl.value_norm(func, mid_it, rho, fns=cfg.fns), step1.diff, step1.active_set)
        return ControlResult(
            mid_it,
            torch.full_like(lamb, params.lamb_init),
            torch.ones_like(lamb, dtype=torch.bool),
            error_sum,
            step1.active_set,
            counters,
            step1.rcond,
            (mid_it.x, mid_it.y),
        )

    return step


def make_controller(cfg: ControlCfg):
    """Factory keyed on StepControlType (reference ``step/step_control.py:123-150``);
    one controller serves one instance and a lane stack."""
    sct = cfg.params.step_control_type
    if sct == StepControlType.DistanceRatio:
        return _distance_ratio(cfg)
    if sct == StepControlType.ResiduumRatio:
        return _residuum_ratio(cfg)
    if sct == StepControlType.Exact:
        return _exact(cfg)
    if sct == StepControlType.Fixed:
        return _fixed(cfg)
    if sct == StepControlType.BoxReduced:
        from .box_control import make_box_reduced

        return make_box_reduced(cfg)
    if sct == StepControlType.Optimizing:
        from .opti_control import make_optimizing

        return make_optimizing(cfg)
    raise ValueError(f"Unknown step control type {sct}")


class ComputedStep(NamedTuple):
    """The (recovered) control result plus the failure evidence the
    solver's eval diagnosis needs."""

    ctrl: ControlResult
    eval_ok: Any  # bool tensor: candidate iterate and lambda were finite
    first_x: Any  # first evaluated inner candidate (before recovery)
    first_y: Any
    cand_x: Any  # final candidate (before recovery)
    cand_y: Any


def compute_step(cfg: ControlCfg, controller, orig: Iterate, lamb, rho, error_sum, counters) -> ComputedStep:
    """Run the controller; a non-finite candidate or lambda (a broken
    factorization, a failed evaluation) becomes a rejected step with
    doubled lambda, per lane on a lane stack."""
    res = controller(orig, lamb, rho, error_sum, counters)
    ok = torch.isfinite(res.lamb)
    for leaf in res.iterate:
        ok = ok & torch.isfinite(leaf).reshape(lamb.shape + (-1,)).all(dim=-1)
    ctrl = res._replace(
        iterate=select(ok, res.iterate, orig),
        lamb=torch.where(ok, res.lamb, 2.0 * lamb),
        accepted=res.accepted & ok,
        error_sum=torch.where(ok, res.error_sum, error_sum),
    )
    return ComputedStep(
        ctrl=ctrl,
        eval_ok=ok,
        first_x=res.first_point[0],
        first_y=res.first_point[1],
        cand_x=res.iterate.x,
        cand_y=res.iterate.y,
    )
