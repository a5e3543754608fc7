"""Step-size control: accept or reject a step and adapt lambda = 1/dt
(counterpart of ``pygradflow_tpu/step/control.py``).

The DistanceRatio controller (the default) is ported.  Where the JAX
package computes both branches under ``lax.cond``/``jnp.where`` and masks,
this eager port branches in Python on the same conditions in the same
order, which takes the same decisions.

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

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import implicit_func as impl
from ..eval import Counters
from ..iterate import Iterate, evaluate_iterate, iterate_eval_counts
from ..newton import NewtonCfg, make_newton
from ..params import ActiveSetType, Params, StepControlType
from .solvers import step_solver_def


class ControlResult(NamedTuple):
    iterate: Iterate  # evaluated candidate iterate
    lamb: float  # next lambda
    accepted: bool
    error_sum: float  # PI integral state
    active_set: Any  # bool (n,) from the last Newton step
    counters: Counters
    rcond: float  # NaN: condition estimates are not ported (ROADMAP A4)
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
    ssdef = step_solver_def(params)
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


def compute_tau(cfg: ControlCfg, it: Iterate, lamb, rho):
    """tau of the active-set projection point: ``None`` for
    ``ActiveSetType.Standard``, the only type ported so far."""
    params = cfg.params
    if params.active_set_method is not None or params.active_set_type != ActiveSetType.Standard:
        raise NotImplementedError(
            "active-set types other than Standard are not yet ported (ROADMAP A5)"
        )
    return None


def _pi_accept(params: Params, lamb, theta, error_sum):
    with np.errstate(over="ignore"):
        error = np.log(params.theta_ref) - np.log(np.float64(theta))
        es_n = error_sum + error
        lamb_mod = np.exp(params.K_P * error + params.K_I * es_n)
    return float(np.maximum(params.lamb_min, lamb / lamb_mod)), float(es_n)


def _pi_reject(params: Params, lamb, error_sum):
    return lamb * params.lamb_inc, (0.0 if error_sum > 0.0 else error_sum)


def _evaluate(cfg: ControlCfg, xn, yn, counters: Counters):
    it = evaluate_iterate(cfg.fns, xn, yn)
    return it, counters.add(**iterate_eval_counts(cfg.m))


def _distance_ratio(cfg: ControlCfg):
    params = cfg.params

    def step(orig: Iterate, lamb, rho, error_sum, counters) -> ControlResult:
        compute_tau(cfg, orig, lamb, rho)
        carry, counters = cfg.newton_init(orig, lamb, rho, counters)
        # controllers measure residuals with the unscaled implicit function
        # (reference distance_ratio_control.py:28)
        func = impl.make_step_func(orig, lamb, cfg.lb, cfg.ub, scaled=False)

        step1, carry, counters = cfg.newton_step(carry, orig, counters)
        mid_it, counters = _evaluate(cfg, step1.xn, step1.yn, counters)
        mid_norm, diff1 = torch.stack([impl.value_norm(func, mid_it, rho), step1.diff]).tolist()
        first = (mid_it.x, mid_it.y)

        conv1 = mid_norm <= params.newton_tol
        zero1 = diff1 == 0.0
        if conv1 or zero1:
            lamb_n = float(np.maximum(lamb * params.lamb_red, params.lamb_min)) if conv1 else lamb
            return ControlResult(
                mid_it, lamb_n, True, error_sum, step1.active_set, counters, step1.rcond, first
            )

        step2, _, counters = cfg.newton_step(carry, mid_it, counters)
        fin_it, counters = _evaluate(cfg, step2.xn, step2.yn, counters)
        diff2 = step2.diff.item()

        if diff2 == 0.0:  # zero second step: accept at unchanged lambda
            return ControlResult(
                fin_it, lamb, True, error_sum, step2.active_set, counters, step2.rcond, first
            )

        theta = diff2 / diff1
        accepted = theta <= params.theta_max
        if accepted:
            lamb_n, es_n = _pi_accept(params, lamb, max(theta, 1e-300), error_sum)
        else:
            lamb_n, es_n = _pi_reject(params, lamb, error_sum)
        return ControlResult(
            fin_it, lamb_n, accepted, es_n, step2.active_set, counters, step2.rcond, first
        )

    return step


def make_controller(cfg: ControlCfg):
    """Factory keyed on StepControlType (reference ``step/step_control.py:123-150``)."""
    sct = cfg.params.step_control_type
    if sct != StepControlType.DistanceRatio:
        item = "A10" if sct in (StepControlType.BoxReduced, StepControlType.Optimizing) else "A5"
        raise NotImplementedError(f"step control {sct.name} is not yet ported (ROADMAP {item})")
    return _distance_ratio(cfg)


def _iterate_finite(it: Iterate) -> bool:
    leaves = [it.x, it.y, it.obj, it.obj_grad, it.cons, it.cons_jac]
    return bool(torch.stack([torch.isfinite(leaf).all() for leaf in leaves]).all())


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
