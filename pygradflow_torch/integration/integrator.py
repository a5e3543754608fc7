"""Adaptive implicit integrators for the stiff restricted flow (counterpart
of ``pygradflow_tpu/integration/integrator.py``).

- **TR-BDF2** (default): the L-stable trapezoidal/BDF2 composite with the
  Hosea-Shampine embedded 3rd-order error estimate; both stages share the
  implicit weight ``d = gamma/2``, so one dense factorization per attempted
  step serves every frozen-Jacobian Newton iteration of both stages.
- **SDIRK4** (Hairer & Wanner II Table 6.5): five implicit stages with one
  shared frozen factorization, order 4 with an embedded order-3 estimate.
- **Implicit Euler** with step-doubling/Richardson error control: three
  full-Newton solves per attempted step.

The JAX package runs the stage Newton, the segment's step loop and the
event bisection as ``lax.while_loop``.  Here each is a masked loop
(``util.masked_while``): an iteration changes only the lanes whose loop
still runs, and counters count only those iterations, so one instance
(0-dim ``h``, vectors (n+m,)) and a lane stack ((B,) ``h``, (B, n+m)
points) take the same decisions.  ``every`` is the host-read cadence of
the loops (0: none, every loop at its full trip count, for a CUDA graph);
the result does not depend on it.  On a CUDA device a step attempt and a
bisection probe replay a pair of CUDA graphs (``graph_pair``), the full
one only when a lane needs more than the fast one's Newton iterations.
"""

import math
from typing import Any, NamedTuple

import torch

from ..linalg.plu import plu_factor, plu_solve
from ..params import IntegrationMethod
from ..util import GraphPair, any_running, lanes, masked_while, rowsum, select
from . import events as ev
from . import flow as fl

NEWTON_MAX_IT = 8
NEWTON_TOL_FACTOR = 1e-3  # relative to the step error tolerance

# event-bisection probe validation: a probe whose flow residuum exceeds
# this factor times the bracket entry's residuum converged to a spurious
# implicit-equation root (see bisect_event)
BISECT_BLOWUP = 100.0

# event-bracket stop tolerance (relative to |t_hi|); 1e-6 flips TR-BDF2
# HS71 to 11 segments against the reference's 10: do not loosen
BISECT_RTOL = 1e-9

# TR-BDF2 constants (gamma = 2 - sqrt(2): equal implicit weights in both
# stages, L-stability)
TRBDF2_GAMMA = 2.0 - math.sqrt(2.0)
TRBDF2_D = TRBDF2_GAMMA / 2.0  # implicit weight, both stages
# stage-2 (BDF2) combination w = AZ*z + AW*w_gamma + D*h*f(w)
TRBDF2_AW = 1.0 / (TRBDF2_GAMMA * (2.0 - TRBDF2_GAMMA))
TRBDF2_AZ = 1.0 - TRBDF2_AW
# embedded error weights: est = h/3 * (E1*f(z) + E2*f(w_gamma) + E3*f(w))
TRBDF2_E1 = math.sqrt(2.0) - 1.0
TRBDF2_E2 = -1.0
TRBDF2_E3 = 2.0 - math.sqrt(2.0)

# SDIRK4: Hairer & Wanner II Table 6.5 (gamma = 1/4), L-stable, stiffly
# accurate, order 4 with an embedded order-3 estimate
SDIRK4_GAMMA = 0.25
SDIRK4_A = (
    (1.0 / 4.0,),
    (1.0 / 2.0, 1.0 / 4.0),
    (17.0 / 50.0, -1.0 / 25.0, 1.0 / 4.0),
    (371.0 / 1360.0, -137.0 / 2720.0, 15.0 / 544.0, 1.0 / 4.0),
    (25.0 / 24.0, -49.0 / 48.0, 125.0 / 16.0, -85.0 / 12.0, 1.0 / 4.0),
)
# b - b_hat: b = last row of A (stiff accuracy), b_hat the embedded
# order-3 weights (59/48, -17/96, 225/32, -85/12, 0)
SDIRK4_E = (-3.0 / 16.0, -27.0 / 32.0, 25.0 / 32.0, 0.0, 1.0 / 4.0)
SDIRK4_C = (0.25, 0.75, 0.55, 0.5, 1.0)  # row sums of SDIRK4_A

READ_EVERY = 1
"""Default host-read cadence of the masked loops."""

FAST_NEWTON_TRIPS = 4
"""Newton iterations of a stage solve in the fast graph of a pair
(``graph_pair``): a lane whose solve has not ended by then is flagged, and
the step is redone by the full graph at ``NEWTON_MAX_IT``."""


def _scaled_norm(v, ref, rtol, atol):
    """scipy-style rms norm with per-component scale atol + rtol*|ref|."""
    scale = atol + rtol * torch.abs(ref)
    r = v / scale
    return torch.sqrt(rowsum(r * r) / r.shape[-1])


def _finite_rows(w):
    return torch.isfinite(w).all(dim=-1)


def _pick_predictor(res_fn, cands, valid=None):
    """The stage-Newton start with the smallest finite stage residual
    among ``cands`` (the first on ties).  Non-finite residuals rank last;
    ``valid`` (optional, parallel to ``cands``) masks candidates out as if
    they were never offered."""
    best, r_best = None, None
    for k, w in enumerate(cands):
        r = fl.norm(res_fn(w))
        r = torch.where(torch.isfinite(r), r, math.inf)
        if valid is not None:
            r = torch.where(torch.as_tensor(valid[k]), r, math.inf)
        if best is None:
            best, r_best = w, r
        else:
            take = r < r_best
            best = torch.where(lanes(take, 1), w, best)
            r_best = torch.where(take, r, r_best)
    return best


def _prefer_challenger(res_fn, incumbent, challenger, valid, margin=0.5):
    """Two-way predictor choice with a decisive margin: the challenger
    replaces the incumbent only when its stage residual is finite and under
    ``margin`` times the incumbent's (or the incumbent's is non-finite).
    Near-equal residuals keep the incumbent, so the pick does not flip on
    last-ulp differences."""
    r_i = fl.norm(res_fn(incumbent))
    r_c = fl.norm(res_fn(challenger))
    better = torch.as_tensor(valid) & torch.isfinite(r_c) & ((r_c < margin * r_i) | ~torch.isfinite(r_i))
    return torch.where(lanes(better, 1), challenger, incumbent)


def _hist_candidate(z, z_prev, h_prev, theta_h):
    """Cross-step linear predictor: extrapolate the line through the last
    two accepted points to the stage time ``t + c_i*h`` (``theta_h`` =
    ``c_i*h``).  ``h_prev <= 0`` marks no history; the caller masks the
    candidate out then (``z`` here is only a finite placeholder)."""
    theta = theta_h / torch.clamp(h_prev, min=1e-300)
    theta = torch.where(h_prev > 0.0, theta, 0.0)
    return z + lanes(theta, 1) * (z - z_prev)


def _newton_cond(carry):
    _, i, err = carry
    return (i < NEWTON_MAX_IT) & (err > NEWTON_TOL_FACTOR)


def _newton_init(w0, err):
    i = torch.zeros(w0.shape[:-1], dtype=torch.int64, device=w0.device)
    return (w0, i, err)


def _eye(z):
    n_all = z.shape[-1]
    return torch.eye(n_all, dtype=z.dtype, device=z.device)


def implicit_euler_step(ctx, z, h, rho, filter, rtol, atol, every=READ_EVERY, escalate=True):
    """One implicit-Euler step: solve w = z + h f(w) by full Newton with
    the dense Jacobian; returns (w, converged, num_newton).  ``escalate`` a
    list: at most ``FAST_NEWTON_TRIPS`` iterations, the mask of the lanes
    still iterating appended to it."""
    h = torch.as_tensor(h, dtype=z.dtype, device=z.device)
    eye = _eye(z)

    def body(carry):
        w, i, err = carry
        f, Jf = fl.rhs_and_jac(ctx, w, rho, filter)
        g = w - z - lanes(h, 1) * f
        A = eye - lanes(h, 2) * Jf
        dw = plu_solve(plu_factor(A), g)
        w = w - dw
        return (w, i + 1, _scaled_norm(dw, w, rtol, atol))

    w0 = z + lanes(h, 1) * fl.rhs(ctx, z, rho, filter)  # explicit predictor
    inf = torch.full(z.shape[:-1], math.inf, dtype=z.dtype, device=z.device)
    trips = NEWTON_MAX_IT if escalate is True else FAST_NEWTON_TRIPS
    carry = masked_while(_newton_cond, body, _newton_init(w0, inf), every, "newton", trips)
    w, iters, err = carry
    ok = (err <= 1.0) & _finite_rows(w)
    if escalate is not True:
        escalate.append(_newton_cond(carry))
    return w, ok, iters


def _make_stage_newton(ctx, fact, dh, rho, filter, rtol, atol, every=READ_EVERY, escalate=True):
    """Shared implicit-stage solver of the DIRK methods: frozen-Jacobian
    iteration first (one shared factorization ``fact`` of ``I - dh*J(z)``),
    escalating to full Newton (fresh ``J(w)`` and refactorization per
    iteration) when the frozen iteration stalls or blows up.

    ``newton(res_fn, w0)`` takes the stage residual as a function
    ``res_fn(w, f_w)`` of the point and the flow there.  ``escalate`` a
    list instead of True: at most ``FAST_NEWTON_TRIPS`` frozen iterations
    and no escalation; the mask of the lanes that still iterate or needed
    the escalation is appended to it (a caller then redoes the step with
    ``escalate`` True)."""
    dh2 = lanes(dh, 2)

    def newton(res_fn, w0):
        eye = _eye(w0)

        def frozen_body(carry):
            w, i, err = carry
            dw = plu_solve(fact, res_fn(w, fl.rhs(ctx, w, rho, filter)))
            w = w - dw
            return (w, i + 1, _scaled_norm(dw, w, rtol, atol))

        def full_body(carry):
            w, i, err = carry
            fw, Jw = fl.rhs_and_jac(ctx, w, rho, filter)
            A = eye - dh2 * Jw
            dw = plu_solve(plu_factor(A), res_fn(w, fw))
            w = w - dw
            return (w, i + 1, _scaled_norm(dw, w, rtol, atol))

        inf = torch.full(w0.shape[:-1], math.inf, dtype=w0.dtype, device=w0.device)
        trips = NEWTON_MAX_IT if escalate is True else FAST_NEWTON_TRIPS
        carry = masked_while(_newton_cond, frozen_body, _newton_init(w0, inf), every, "newton", trips)
        w, iters, err = carry
        ok = (err <= 1.0) & _finite_rows(w)
        if escalate is not True:
            escalate.append(~ok | _newton_cond(carry))
            return w, ok, iters

        # escalation: a from-scratch restart at w0, not warm-started (full
        # Newton from a diverged endpoint lands on wrong stage roots).
        # err_start keeps the converged lanes out of the loop: they take
        # the frozen result, and the loop runs no iteration when none
        # escalates
        err_start = torch.where(ok, 0.0, inf)
        wf, itf, errf = masked_while(
            _newton_cond, full_body, _newton_init(w0, err_start), every, "newton", NEWTON_MAX_IT
        )
        okf = (errf <= 1.0) & _finite_rows(wf)
        return (
            torch.where(lanes(ok, 1), w, wf),
            ok | okf,
            torch.where(ok, iters, iters + itf),
        )

    return newton


def _stage_res(base, dh, f_extra=None):
    """The stage residual ``w - base - dh*(f_extra + f(w))`` as a function
    of ``(w, f(w))``."""
    dhl = lanes(dh, 1)
    if f_extra is None:
        return lambda w, fw: w - base - dhl * fw
    return lambda w, fw: w - base - dhl * (f_extra + fw)


def _with_rhs(ctx, rho, filter, res_fn):
    return lambda w: res_fn(w, fl.rhs(ctx, w, rho, filter))


def trbdf2_step(ctx, z, h, rho, filter, rtol, atol, hist=None, every=READ_EVERY, escalate=True):
    """One TR-BDF2 step from ``z``: TR stage to ``z + gamma*h``, BDF2 stage
    to ``z + h``, both with the frozen matrix ``M = I - d*h*J(z)``.
    ``hist = (z_prev, h_prev)`` is the previous accepted point.  Returns
    ``(w, ok, num_newton, est)``, ``est`` the stiffly filtered embedded
    local-error estimate."""
    h = torch.as_tensor(h, dtype=z.dtype, device=z.device)
    fz, J = fl.rhs_and_jac(ctx, z, rho, filter)
    M = _eye(z) - lanes(TRBDF2_D * h, 2) * J
    fact = plu_factor(M)

    dh = TRBDF2_D * h
    newton = _make_stage_newton(ctx, fact, dh, rho, filter, rtol, atol, every, escalate)
    hl = lanes(h, 1)

    # TR stage: w1 = z + d*h*(f(z) + f(w1))
    res1 = _stage_res(z, dh, fz)
    w1_init = z + lanes(TRBDF2_GAMMA * h, 1) * fz
    if hist is not None:
        z_prev, h_prev = hist
        w1_init = _prefer_challenger(
            _with_rhs(ctx, rho, filter, res1),
            w1_init,
            _hist_candidate(z, z_prev, h_prev, TRBDF2_GAMMA * h),
            h_prev > 0.0,
        )
    w1, ok1, it1 = newton(res1, w1_init)
    f1 = fl.rhs(ctx, w1, rho, filter)

    # BDF2 stage: w = az*z + aw*w1 + d*h*f(w); the f-based and the
    # intra-step linear predictors, the smaller stage residual wins (the
    # cross-step candidate is offered at stage 1 only)
    base = TRBDF2_AZ * z + TRBDF2_AW * w1
    res2 = _stage_res(base, dh)
    cands2 = [base + lanes(dh, 1) * f1, z + (1.0 / TRBDF2_GAMMA) * (w1 - z)]
    w_init = _pick_predictor(_with_rhs(ctx, rho, filter, res2), cands2)
    w, ok2, it2 = newton(res2, w_init)
    fw = fl.rhs(ctx, w, rho, filter)

    # embedded 3rd-order error estimate, filtered through M^{-1}
    est = (hl / 3.0) * (TRBDF2_E1 * fz + TRBDF2_E2 * f1 + TRBDF2_E3 * fw)
    est = plu_solve(fact, est)

    return w, ok1 & ok2, it1 + it2, est


def sdirk4_step(ctx, z, h, rho, filter, rtol, atol, hist=None, every=READ_EVERY, escalate=True):
    """One SDIRK4 step from ``z``: five implicit stages with implicit weight
    ``h/4``, one frozen factorization ``M = I - h/4 J(z)`` for every stage.
    Stiffly accurate, L-stable, order 4 with an embedded order-3 estimate
    filtered through ``M^{-1}``.  Returns ``(w, ok, num_newton, est)``."""
    h = torch.as_tensor(h, dtype=z.dtype, device=z.device)
    fz, J = fl.rhs_and_jac(ctx, z, rho, filter)
    dh = SDIRK4_GAMMA * h
    M = _eye(z) - lanes(dh, 2) * J
    fact = plu_factor(M)

    newton = _make_stage_newton(ctx, fact, dh, rho, filter, rtol, atol, every, escalate)

    fs = []
    y_prev = None
    f_pred = fz
    ok = torch.ones(z.shape[:-1], dtype=torch.bool, device=z.device)
    iters = torch.zeros(z.shape[:-1], dtype=torch.int64, device=z.device)
    for i in range(5):
        base = z
        for j in range(i):
            base = base + lanes(h * SDIRK4_A[i][j], 1) * fs[j]
        res_fn = _stage_res(base, dh)

        # the f-based predictor against the linear-in-t extrapolations: of
        # the previous stage within this step (stages 2-5), and of the
        # previous accepted step at stage 1 only, on a decisive margin
        w_init = base + lanes(dh, 1) * f_pred
        if i > 0:
            w_init = _pick_predictor(
                _with_rhs(ctx, rho, filter, res_fn),
                [w_init, z + (SDIRK4_C[i] / SDIRK4_C[i - 1]) * (y_prev - z)],
            )
        elif hist is not None:
            z_prev, h_prev = hist
            w_init = _prefer_challenger(
                _with_rhs(ctx, rho, filter, res_fn),
                w_init,
                _hist_candidate(z, z_prev, h_prev, SDIRK4_C[i] * h),
                h_prev > 0.0,
            )
        y_i, ok_i, it_i = newton(res_fn, w_init)
        f_i = fl.rhs(ctx, y_i, rho, filter)
        fs.append(f_i)
        y_prev = y_i
        f_pred = f_i
        ok = ok & ok_i
        iters = iters + it_i
    w = y_i  # stiffly accurate: b = last row of A

    total = 0
    for e, f in zip(SDIRK4_E, fs):
        total = total + e * f
    est = plu_solve(fact, lanes(h, 1) * total)
    return w, ok, iters, est


class SegmentResult(NamedTuple):
    t_prev: Any
    z_prev: Any
    t: Any
    z: Any
    h: Any
    crossed: Any  # bool vector over events (crossing within last step)
    status: Any  # 0 = event, 1 = reached t_end, 2 = step failure/underflow
    num_steps: Any
    num_newton: Any


FACTOR_QUANTUM = 2.0**-30
"""The controller's step factor is rounded to a multiple of this: ``pow``
may differ in its last bit between the CPU's libm and the card, and the
engines' event sequences amplify a last-bit difference of a step size."""


def controller_factor(err_ratio, ok, exponent, cap):
    """Step-size factor ``0.9 * err^exponent`` clipped to ``[0.2, cap]``,
    0.5 after a failed Newton solve."""
    factor = torch.where(err_ratio > 0.0, 0.9 * err_ratio**exponent, cap)
    factor = torch.clamp(factor, 0.2, cap)
    factor = torch.round(factor / FACTOR_QUANTUM) * FACTOR_QUANTUM
    return torch.where(ok, factor, 0.5)


def make_step_with_error(ctx, method, rtol, atol):
    """``step(z, h, rho, filter, hist, every, escalate) -> (w, accept,
    factor, num_newton)``: one attempted step of ``method`` with its error
    control."""

    def euler(z, h, rho, filter, hist=None, every=READ_EVERY, escalate=True):
        w_full, ok1, n1 = implicit_euler_step(ctx, z, h, rho, filter, rtol, atol, every, escalate)
        w_half, ok2, n2 = implicit_euler_step(ctx, z, 0.5 * h, rho, filter, rtol, atol, every, escalate)
        w_two, ok3, n3 = implicit_euler_step(ctx, w_half, 0.5 * h, rho, filter, rtol, atol, every, escalate)
        err_ratio = _scaled_norm(w_two - w_full, w_two, rtol, atol)
        ok = ok1 & ok2 & ok3
        accept = ok & (err_ratio <= 1.0)
        # Richardson extrapolation of the step-doubled solution
        w_acc = 2.0 * w_two - w_full
        return w_acc, accept, controller_factor(err_ratio, ok, -0.5, 5.0), n1 + n2 + n3

    def dirk(step_fn, exponent):
        def step(z, h, rho, filter, hist=None, every=READ_EVERY, escalate=True):
            w, ok, iters, est = step_fn(ctx, z, h, rho, filter, rtol, atol, hist, every, escalate)
            err_ratio = _scaled_norm(est, w, rtol, atol)
            accept = ok & (err_ratio <= 1.0)
            return w, accept, controller_factor(err_ratio, ok, exponent, 10.0), iters

        return step

    return {
        IntegrationMethod.TRBDF2: dirk(trbdf2_step, -1.0 / 3.0),
        IntegrationMethod.SDIRK4: dirk(sdirk4_step, -1.0 / 4.0),
        IntegrationMethod.ImplicitEuler: euler,
    }[method]


def _any_of(masks, like):
    """The lanes of any mask in ``masks`` (none: no lane)."""
    out = torch.zeros_like(like, dtype=torch.bool)
    for mask in masks:
        out = out | mask
    return out


def graph_pair(fn, loop):
    """``fn(*tensors, every, escalate)`` as a ``util.GraphPair`` with no host
    read inside: the full graph runs every loop to its full trip count, the
    fast one runs each Newton solve for ``FAST_NEWTON_TRIPS`` iterations
    without the stage escalation, and flags the lanes where that is not the
    full result (its last output, masked by the lanes ``fn`` applies to)."""

    def fast(*tensors):
        needs = []
        out, applies = fn(*tensors, every=0, escalate=needs)
        return out + (_any_of(needs, applies) & applies,)

    def full(*tensors):
        out, applies = fn(*tensors, every=0, escalate=True)
        return out + (torch.zeros_like(applies, dtype=torch.bool),)

    return GraphPair(fast, full, loop)


def make_single_step(ctx, method, rtol, atol, every=READ_EVERY):
    """``single(z, h, rho, filter) -> (w, ok)``: one plain step of
    ``method`` with no history (the bisection probe).  On a CUDA device it
    replays a CUDA graph pair (``graph_pair``)."""
    if method == IntegrationMethod.ImplicitEuler:

        def plain(z, h, rho, filter, every=every, escalate=True):
            w, ok, _ = implicit_euler_step(ctx, z, h, rho, filter, rtol, atol, every, escalate)
            return w, ok

    else:
        step_fn = trbdf2_step if method == IntegrationMethod.TRBDF2 else sdirk4_step

        def plain(z, h, rho, filter, every=every, escalate=True):
            w, ok, _, _ = step_fn(ctx, z, h, rho, filter, rtol, atol, None, every, escalate)
            return w, ok

    def graphed_fn(z, h, rho, filter, every, escalate):
        w, ok = plain(z, h, rho, filter, every, escalate)
        return (w, ok), torch.ones_like(ok)

    pair = graph_pair(graphed_fn, "newton")

    def single(z, h, rho, filter):
        if not z.is_cuda:
            return plain(z, h, rho, filter)
        as_t = lambda v: torch.as_tensor(v, dtype=z.dtype, device=z.device)  # noqa: E731
        w, ok, _ = pair(z, as_t(h), as_t(rho), filter)
        return w.clone(), ok.clone()

    return single


def make_segment_runner(
    cfg: ev.EventCfg,
    method: IntegrationMethod = IntegrationMethod.TRBDF2,
    rtol=1e-6,
    atol=1e-9,
    max_steps=300_000,
    every=READ_EVERY,
):
    """Build ``(run, single)``: the segment integrator for a fixed event
    configuration and the plain single step.

    ``run(t0, z0, h0, rho, filter, grad_dirs, t_end, active=None)``
    integrates until an event, ``t_end`` or a breakdown; ``active`` (bool,
    per lane) leaves the lanes where it is false with status 1 and no step.
    On a CUDA device each step attempt replays a CUDA graph pair
    (``graph_pair``) and the host reads after it whether the segment still
    runs."""
    ctx = cfg.ctx
    step_with_error = make_step_with_error(ctx, method, rtol, atol)
    every_step = every or 1  # the step loop has no trip count
    keys = ("t_prev", "z_prev", "t", "z", "h", "h_last", "vals", "crossed", "status", "steps", "newtons")

    def body(c, rho, filter, grad_dirs, dirs, t_end, every=every, escalate=True):
        h = torch.minimum(c["h"], t_end - c["t"])
        # cross-step predictor history: the previous accepted point
        # (h_last == 0 at segment start marks no history)
        hist = (c["z_prev"], c["h_last"])
        w, accept, factor, n_newton = step_with_error(c["z"], h, rho, filter, hist, every, escalate)

        new_vals = ev.event_values(cfg, w, rho, filter, grad_dirs)
        crossed = ev.crossings(c["vals"], new_vals, dirs)
        any_crossed = crossed.any(dim=-1)

        t_new = c["t"] + h
        h_new = torch.clamp(c["h"] * factor, min=1e-14)

        # underflow test on the controller's step, not the t_end-clamped
        # one: h == t_end - t tiny is a normal final step.  Threshold
        # ~16*eps*t: below it t+h == t
        broke = (c["steps"] >= max_steps) | (c["h"] <= 3.6e-15 * torch.clamp(c["t"], min=1.0))
        status = torch.where(
            accept & any_crossed,
            0,
            torch.where(accept & (t_new >= t_end), 1, torch.where(broke, 2, -1)),
        )
        acc = lanes(accept, 1)
        return dict(
            t_prev=torch.where(accept, c["t"], c["t_prev"]),
            z_prev=torch.where(acc, c["z"], c["z_prev"]),
            t=torch.where(accept, t_new, c["t"]),
            z=torch.where(acc, w, c["z"]),
            h=h_new,
            h_last=torch.where(accept, h, c["h_last"]),
            vals=torch.where(acc, new_vals, c["vals"]),
            crossed=torch.where(acc, crossed, c["crossed"]),
            status=status,
            steps=c["steps"] + 1,
            newtons=c["newtons"] + n_newton,
        )

    def cond(c):
        return c["status"] == -1

    def graphed_fn(*tensors, every, escalate):
        c = dict(zip(keys, tensors[: len(keys)]))
        active = cond(c)
        new = select(active, body(c, *tensors[len(keys):], every, escalate), c)
        return tuple(new[k] for k in keys), active

    pair = graph_pair(graphed_fn, "newton")

    def run(t0, z0, h0, rho, filter, grad_dirs, t_end, active=None):
        dirs = ev.event_directions(cfg, filter, grad_dirs)
        vals0 = ev.event_values(cfg, z0, rho, filter, grad_dirs)
        running = torch.full_like(t0, -1, dtype=torch.int64)
        if active is not None:
            running = torch.where(active, running, 1)
        zero = torch.zeros_like(t0, dtype=torch.int64)

        init = dict(
            t_prev=t0,
            z_prev=z0,
            t=t0,
            z=z0,
            h=h0,
            # size of the last accepted step (0 = no in-segment history),
            # stored as it is rather than recomputed as t - t_prev, so that
            # the flat engine, which stores it the same way, stays equal
            h_last=torch.zeros_like(t0),
            vals=vals0,
            crossed=torch.zeros_like(vals0, dtype=torch.bool),
            status=running,
            steps=zero,
            newtons=zero,
        )

        if z0.is_cuda:
            extras = (torch.as_tensor(rho, dtype=z0.dtype, device=z0.device), filter, grad_dirs, dirs, t_end)
            c = init
            while any_running(cond(c), "segment"):
                c = dict(zip(keys, pair(*(c[k] for k in keys), *extras)[: len(keys)]))
            out = {k: v.clone() for k, v in c.items()}  # off the graph's buffers
        else:
            out = masked_while(
                cond, lambda c: body(c, rho, filter, grad_dirs, dirs, t_end), init, every_step, "segment"
            )
        return SegmentResult(
            t_prev=out["t_prev"],
            z_prev=out["z_prev"],
            t=out["t"],
            z=out["z"],
            h=out["h"],
            crossed=out["crossed"],
            status=out["status"],
            num_steps=out["steps"],
            num_newton=out["newtons"],
        )

    return run, make_single_step(ctx, method, rtol, atol, every)


def bisect_event(
    cfg,
    step_fn,
    run_vals,
    t_prev,
    z_prev,
    t_cur,
    rho,
    filter,
    grad_dirs,
    max_bisect=50,
    z_end=None,
):
    """Host-driven bisection: shrink the event bracket [t_prev, t_cur] by
    single steps from ``z_prev``; returns the refined (t, z, crossed) at
    the post-crossing side.

    ``z_end`` is the segment integrator's own accepted state at ``t_cur``:
    when the bisection never re-finds the crossing it is the fallback, not
    one step across the whole remaining bracket (whose Newton diverges near
    convergence).  A probe whose flow residuum exceeds ``BISECT_BLOWUP``
    times the bracket entry's converged to a spurious root and is treated
    as a failed probe."""
    dirs = ev.event_directions(cfg, filter, grad_dirs)
    vals_prev = run_vals(z_prev)
    # the conv event slot is residuum - opt_tol: probe residuums are free
    res_entry = float(vals_prev[3 * cfg.ctx.n]) + cfg.opt_tol

    t_lo, z_lo = float(t_prev), z_prev
    t_hi = float(t_cur)
    z_hi = None  # state at t_hi computed lazily

    for _ in range(max_bisect):
        if t_hi - t_lo <= BISECT_RTOL * max(1.0, abs(t_hi)):
            break
        t_mid = 0.5 * (t_lo + t_hi)
        h = t_mid - t_lo
        z_mid, ok = step_fn(z_lo, h, rho, filter)
        if not bool(ok):
            break
        vals_mid = run_vals(z_mid)
        res_mid = float(vals_mid[3 * cfg.ctx.n]) + cfg.opt_tol
        if not math.isfinite(res_mid) or res_mid > BISECT_BLOWUP * res_entry:
            break
        crossed = ev.crossings(vals_prev, vals_mid, dirs)
        if bool(crossed.any()):
            t_hi = t_mid
            z_hi = z_mid
        else:
            t_lo, z_lo = t_mid, z_mid
            vals_prev = vals_mid

    if z_hi is None:
        if z_end is not None:
            z_hi = z_end
        else:
            # no segment endpoint given: one step to the end of the
            # bracket, rejected if its Newton fails
            z_hi, ok = step_fn(z_lo, t_hi - t_lo, rho, filter)
            if not bool(ok) or not bool(torch.isfinite(z_hi).all()):
                z_hi = z_lo

    vals_hi = run_vals(z_hi)
    crossed = ev.crossings(vals_prev, vals_hi, dirs)
    return t_hi, z_hi, crossed
