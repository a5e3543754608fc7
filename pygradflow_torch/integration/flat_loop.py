"""The flat engine: the continuous-homotopy solve as one loop of uniform
work units, for batches and time-limited single solves (counterpart of
``pygradflow_tpu/integration/flat_loop.py``).

Each iteration performs exactly one work unit per lane: one adaptive step
attempt, or one bisection probe, with segment transitions and event
application as masked updates.  Lanes advance through their own phases
(the modes STEP, BISECT and DONE) independently, so a batch's critical
path is the largest per-lane unit count.  Execution is chunked: the caller
checks ``params.time_limit`` and harvests finished lanes between chunks.

The state is a dict of tensors, 0-dim for one instance or with a leading
lane axis for a stack.  With ``every`` 0 a unit computes every update
family on every lane and reads nothing on the host, as a CUDA graph needs;
otherwise a family that no lane takes is skipped after a host read.  The
result is the same bits either way.

Semantics mirror ``device_loop.py`` decision for decision (same steps,
same bracket updates, same event priority and boundary checks) with the
JAX package's two deviations: under ``IntegrationMethod.ImplicitEuler``
the bisection probes take the step-doubled, extrapolated step and its
error is measured against the extrapolated point, since the unit shares
one step kernel; and ``path_dist`` adds the distance to the event point
after its clip into the box.
"""

from typing import Any, NamedTuple

import torch

from ..params import IntegrationMethod
from ..status import RUNNING, SolverStatus
from ..util import any_running, lanes, masked_while, select
from . import events as ev
from . import flow as fl
from .device_loop import MAX_BISECT, _create_filter, apply_event, termination
from .integrator import (
    BISECT_BLOWUP,
    BISECT_RTOL,
    READ_EVERY,
    _scaled_norm,
    controller_factor,
    implicit_euler_step,
    sdirk4_step,
    trbdf2_step,
)

# modes of the per-lane state machine
STEP = 0
BISECT = 1
DONE = 2


class FlatLoopResult(NamedTuple):
    z: Any
    status: Any
    iterations: Any
    rho: Any
    num_steps: Any
    num_newtons: Any
    path_dist: Any


def _needed(mask, every):
    """Whether an update family must be computed: always without host
    reads, else when a lane takes it."""
    return not every or any_running(mask, "branch")


def make_flat_loop(cfg, fns, lb, ub, params):
    """Build ``(init, chunk, collect)`` for the flat engine.

    - ``init(x, y) -> state``;
    - ``chunk(state, budget, every, escalate) -> state``: up to ``budget``
      work units while a lane runs, freezing lanes whose status leaves
      RUNNING; the host reads whether a lane runs before every
      ``every``-th unit (0: no read, ``budget`` units, inner loops at their
      full trip count); ``escalate`` as in ``integrator.trbdf2_step``;
    - ``collect(state) -> FlatLoopResult``.
    """
    ctx = cfg.ctx
    n = ctx.n
    iteration_limit = params.iteration_limit or params.iteration_limit_default
    opt_tol = params.opt_tol
    max_steps = params.integration_max_steps
    rtol, atol = params.integration_rtol, params.integration_atol
    method = params.integration_method

    if method == IntegrationMethod.SDIRK4:

        def step_full(z, h, rho, filt, hist, every, escalate):
            return sdirk4_step(ctx, z, h, rho, filt, rtol, atol, hist, every, escalate)

        err_exponent = -1.0 / 4.0
    elif method == IntegrationMethod.TRBDF2:

        def step_full(z, h, rho, filt, hist, every, escalate):
            return trbdf2_step(ctx, z, h, rho, filt, rtol, atol, hist, every, escalate)

        err_exponent = -1.0 / 3.0
    else:

        def step_full(z, h, rho, filt, hist, every, escalate):
            """Step-doubled implicit Euler in the (w, ok, iters, est) form:
            est from the Richardson difference."""
            w_full, ok1, n1 = implicit_euler_step(ctx, z, h, rho, filt, rtol, atol, every, escalate)
            w_half, ok2, n2 = implicit_euler_step(ctx, z, 0.5 * h, rho, filt, rtol, atol, every, escalate)
            w_two, ok3, n3 = implicit_euler_step(ctx, w_half, 0.5 * h, rho, filt, rtol, atol, every, escalate)
            ok = ok1 & ok2 & ok3
            w_acc = 2.0 * w_two - w_full
            return w_acc, ok, n1 + n2 + n3, w_two - w_full

        err_exponent = -1.0 / 2.0

    # ------------------------------------------------------------------

    def _transition(c):
        """Segment boundary: iteration-limit check, termination checks at
        the (new) point, and next-segment initialization.  Applied masked:
        ``c`` already holds the post-event state."""
        z, filt, rho = c["z"], c["filter"], c["rho"]
        status = c["status"]

        status = torch.where(
            (c["iteration"] >= iteration_limit) & (status == RUNNING), int(SolverStatus.IterationLimit), status
        )
        status = termination(ctx, fns, lb, ub, params, z, filt, status)

        grad_dirs = ev.grad_event_dirs(ctx, z, filt, lb, ub)
        vals = ev.event_values(cfg, z, rho, filt, grad_dirs)
        dirs = ev.event_directions(cfg, filt, grad_dirs)

        return dict(
            c,
            status=status,
            mode=torch.where(status == RUNNING, STEP, DONE),
            grad_dirs=grad_dirs,
            vals=vals,
            dirs=dirs,
            seg_t_end=c["t"] + 1e10,
            seg_z0=z,
            seg_steps=torch.zeros_like(c["seg_steps"]),
            # the nested engines start every segment with no predictor
            # history; so does the flat one
            hist_h=torch.zeros_like(c["hist_h"]),
        )

    # ------------------------------------------------------------------

    def init(x, y):
        z = torch.cat([x, y], dim=-1)
        lead = z.shape[:-1]
        dt, dev = z.dtype, z.device

        def full(value, dtype=dt, shape=()):
            return torch.full(lead + shape, value, dtype=dtype, device=dev)

        rho0 = full(params.rho)
        n_ev = ev.num_events(n)
        zero_i = full(0, torch.int64)
        c = dict(
            z=z,
            t=full(0.0),
            h=full(1e-4),
            rho=rho0,
            filter=_create_filter(ctx, lb, ub, z, rho0),
            status=full(RUNNING, torch.int64),
            mode=full(STEP, torch.int64),
            iteration=zero_i,
            steps=zero_i,
            newtons=zero_i,
            seg_steps=zero_i,
            path_dist=full(0.0),
            grad_dirs=full(0.0, shape=(n,)),
            vals=full(0.0, shape=(n_ev,)),
            dirs=full(0.0, shape=(n_ev,)),
            seg_t_end=full(0.0),
            seg_z0=z,
            bis_t_lo=full(0.0),
            bis_z_lo=z,
            bis_vals_lo=full(0.0, shape=(n_ev,)),
            bis_res0=full(0.0),
            bis_t_hi=full(0.0),
            bis_z_hi=z,
            bis_vals_hi=full(0.0, shape=(n_ev,)),
            bis_has_hi=full(False, torch.bool),
            bis_stop=full(False, torch.bool),
            bis_i=zero_i,
            z_end=z,
            vals_end=full(0.0, shape=(n_ev,)),
            # cross-step predictor history (h <= 0 marks no history)
            hist_z=z,
            hist_h=full(0.0),
            # total work units (step attempts + bisection probes): the
            # lane's share of the lockstep critical path
            units=zero_i,
        )
        return _transition(c)

    # ------------------------------------------------------------------

    def body(c, every=READ_EVERY, escalate=True):
        rho, filt = c["rho"], c["filter"]
        is_step = c["mode"] == STEP
        is_bis = c["mode"] == BISECT

        # bisection-done test on the current bracket (the device loop tests
        # its cond before each bisection step)
        gap = c["bis_t_hi"] - c["bis_t_lo"]
        bis_runs = (
            (c["bis_i"] < MAX_BISECT)
            & ~c["bis_stop"]
            & (gap > BISECT_RTOL * torch.clamp(torch.abs(c["bis_t_hi"]), min=1.0))
        )
        bis_done = is_bis & ~bis_runs
        do_bis = is_bis & ~bis_done

        # ---- the work unit: one implicit step from the selected inputs
        t_mid = 0.5 * (c["bis_t_lo"] + c["bis_t_hi"])
        z_in = torch.where(lanes(do_bis, 1), c["bis_z_lo"], c["z"])
        h_step = torch.minimum(c["h"], c["seg_t_end"] - c["t"])
        h_in = torch.where(do_bis, t_mid - c["bis_t_lo"], h_step)
        # frozen lanes / zero brackets: keep the kernel numerically alive
        h_in = torch.clamp(h_in, min=1e-300)

        # the cross-step history applies to STEP-mode lanes only (a probe
        # re-steps from the bracket start)
        hist = (c["hist_z"], torch.where(do_bis, 0.0, c["hist_h"]))
        w, ok, n_newton, est = step_full(z_in, h_in, rho, filt, hist, every, escalate)
        new_vals = ev.event_values(cfg, w, rho, filt, c["grad_dirs"])

        # ---- STEP-mode update (mirrors make_segment_runner's body)
        err_ratio = _scaled_norm(est, w, rtol, atol)
        accept = ok & (err_ratio <= 1.0)
        factor = controller_factor(err_ratio, ok, err_exponent, 10.0)

        crossed_step = ev.crossings(c["vals"], new_vals, c["dirs"])
        any_crossed = crossed_step.any(dim=-1)
        t_new = c["t"] + h_in

        ev_any = accept & any_crossed
        # a pure-convergence crossing needs no bisection: any point past it
        # has residuum <= opt_tol (only when conv is the sole crossed event)
        conv_only = crossed_step[..., 3 * n] & (crossed_step.sum(dim=-1) == 1)
        ev_direct = ev_any & conv_only
        ev_enter = ev_any & ~conv_only
        tend_hit = accept & ~any_crossed & (t_new >= c["seg_t_end"])
        brk = ~(ev_any | tend_hit) & (
            (c["seg_steps"] >= max_steps) | (c["h"] <= 3.6e-15 * torch.clamp(c["t"], min=1.0))
        )
        normal = accept & ~(ev_any | tend_hit)

        h_new = torch.clamp(c["h"] * factor, min=1e-14)

        cs = dict(c)
        cs["steps"] = c["steps"] + 1
        cs["seg_steps"] = c["seg_steps"] + 1
        cs["newtons"] = c["newtons"] + n_newton
        cs["h"] = h_new
        adv = normal | tend_hit
        adv1 = lanes(adv, 1)
        cs["t"] = torch.where(adv, t_new, c["t"])
        cs["z"] = torch.where(adv1, w, c["z"])
        cs["vals"] = torch.where(adv1, new_vals, c["vals"])
        cs["hist_z"] = torch.where(adv1, c["z"], c["hist_z"])
        cs["hist_h"] = torch.where(adv, h_in, c["hist_h"])
        # entering bisection: bracket [t, t_new] from the accepted state
        enter1 = lanes(ev_enter, 1)
        cs["bis_t_lo"] = torch.where(ev_enter, c["t"], c["bis_t_lo"])
        cs["bis_z_lo"] = torch.where(enter1, c["z"], c["bis_z_lo"])
        cs["bis_vals_lo"] = torch.where(enter1, c["vals"], c["bis_vals_lo"])
        # bracket-entry residuum, the scale of the spurious-root guard (the
        # conv slot is residuum - opt_tol)
        cs["bis_res0"] = torch.where(ev_enter, c["vals"][..., 3 * n] + opt_tol, c["bis_res0"])
        cs["bis_t_hi"] = torch.where(ev_enter, t_new, c["bis_t_hi"])
        cs["bis_has_hi"] = c["bis_has_hi"] & ~ev_enter
        cs["bis_stop"] = c["bis_stop"] & ~ev_enter
        cs["bis_i"] = torch.where(ev_enter, 0, c["bis_i"])
        cs["z_end"] = torch.where(enter1, w, c["z_end"])
        cs["vals_end"] = torch.where(enter1, new_vals, c["vals_end"])
        cs["mode"] = torch.where(ev_enter, BISECT, c["mode"])
        # breakdown: stop with IterationLimit at the segment's accepted state
        cs["status"] = torch.where(brk, int(SolverStatus.IterationLimit), cs["status"])
        cs["mode"] = torch.where(brk, DONE, cs["mode"])
        cs["iteration"] = c["iteration"] + brk
        # segment end via t_end: path, counters, then the transition below
        cs["path_dist"] = torch.where(tend_hit, c["path_dist"] + fl.norm(w - c["seg_z0"]), c["path_dist"])
        cs["h"] = torch.where(tend_hit, torch.clamp(h_new, min=1e-10), cs["h"])
        cs["iteration"] = cs["iteration"] + tend_hit
        # direct convergence (conv-only crossing): the event at the accepted
        # endpoint (box clip, path_dist, iteration count, Optimal)
        x_w, y_w = fl.split(ctx, w)
        z_conv = torch.cat([torch.clamp(x_w, lb, ub), y_w], dim=-1)
        cs["t"] = torch.where(ev_direct, t_new, cs["t"])
        cs["z"] = torch.where(lanes(ev_direct, 1), z_conv, cs["z"])
        cs["path_dist"] = torch.where(
            ev_direct, c["path_dist"] + fl.norm(z_conv - c["seg_z0"]), cs["path_dist"]
        )
        cs["iteration"] = cs["iteration"] + ev_direct
        cs["status"] = torch.where(ev_direct, int(SolverStatus.Optimal), cs["status"])
        cs["mode"] = torch.where(ev_direct, DONE, cs["mode"])

        # ---- BISECT-step update (the device loop's bisection body, with
        # the spurious-root probe guard)
        res_w = new_vals[..., 3 * n] + opt_tol
        ok_probe = ok & torch.isfinite(res_w) & (res_w <= BISECT_BLOWUP * c["bis_res0"])
        crossed_mid = ev.crossings(c["bis_vals_lo"], new_vals, c["dirs"]).any(dim=-1)
        hi_branch = ok_probe & crossed_mid
        lo_branch = ok_probe & ~crossed_mid
        lo1, hi1 = lanes(lo_branch, 1), lanes(hi_branch, 1)
        cb = dict(c)
        cb["bis_t_lo"] = torch.where(lo_branch, t_mid, c["bis_t_lo"])
        cb["bis_z_lo"] = torch.where(lo1, w, c["bis_z_lo"])
        cb["bis_vals_lo"] = torch.where(lo1, new_vals, c["bis_vals_lo"])
        cb["bis_t_hi"] = torch.where(hi_branch, t_mid, c["bis_t_hi"])
        cb["bis_z_hi"] = torch.where(hi1, w, c["bis_z_hi"])
        cb["bis_vals_hi"] = torch.where(hi1, new_vals, c["bis_vals_hi"])
        cb["bis_has_hi"] = c["bis_has_hi"] | hi_branch
        cb["bis_stop"] = ~ok_probe
        cb["bis_i"] = c["bis_i"] + 1

        # ---- merge the update families
        out = select(is_step, cs, c)
        out = select(do_bis, cb, out)
        if _needed(bis_done, every):
            out = select(bis_done, apply_at_event(c, every), out)

        # segment transitions re-run the boundary checks and segment init
        trans = (is_step & tend_hit) | bis_done
        if _needed(trans, every):
            out = select(trans, _transition(out), out)
        # terminal statuses reached inside the event application
        out["mode"] = torch.where(out["status"] == RUNNING, out["mode"], DONE)
        out["units"] = c["units"] + 1
        return out

    def apply_at_event(c, every):
        """The event application of a finished bisection."""
        has_hi = c["bis_has_hi"]
        z_hi = torch.where(lanes(has_hi, 1), c["bis_z_hi"], c["z_end"])
        vals_hi = torch.where(lanes(has_hi, 1), c["bis_vals_hi"], c["vals_end"])
        crossed_ev = ev.crossings(c["bis_vals_lo"], vals_hi, c["dirs"])
        x_ev, y_ev = fl.split(ctx, z_hi)
        z_ev = torch.cat([torch.clamp(x_ev, lb, ub), y_ev], dim=-1)

        ca = dict(c)
        ca["path_dist"] = c["path_dist"] + fl.norm(z_ev - c["seg_z0"])
        ca["t"] = c["bis_t_hi"]
        ca["z"] = z_ev
        ca["h"] = torch.full_like(c["h"], 1e-4)
        ca["hist_h"] = torch.zeros_like(c["hist_h"])  # the flow changed at the event
        ca["iteration"] = c["iteration"] + 1
        ca["filter"], ca["status"], ca["rho"] = apply_event(
            ctx, fns, lb, ub, opt_tol, crossed_ev, z_ev, c["filter"], c["rho"], c["status"], every
        )
        return ca

    # ------------------------------------------------------------------

    def running(state):
        return state["status"] == RUNNING

    def chunk(state, budget: int, every=READ_EVERY, escalate=True):
        return masked_while(running, lambda c: body(c, every, escalate), state, every, "flat", budget)

    def collect(state) -> FlatLoopResult:
        return FlatLoopResult(
            z=state["z"],
            status=state["status"],
            iterations=state["iteration"],
            rho=state["rho"],
            num_steps=state["steps"],
            num_newtons=state["newtons"],
            path_dist=state["path_dist"],
        )

    return init, chunk, collect
