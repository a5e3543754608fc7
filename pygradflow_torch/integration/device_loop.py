"""The device engine: the whole continuous-homotopy solve (segments, event
bisection, filter and penalty switches, termination) as one loop over
tensors (counterpart of ``pygradflow_tpu/integration/device_loop.py``).

The JAX package traces it into one ``lax.while_loop`` with ``lax.cond``
branches.  Here every branch is computed and selected per lane
(``torch.where``), and the loops are masked (``util.masked_while``):
a branch that no lane takes runs its loops for no iteration, which the
host reads before each of them.  The decisions are those of the JAX
device loop, in its order, on one instance (0-dim state).

Deviations from the host engine, as in the JAX package:
- no ``collect_path`` and no live display;
- the degenerate-bound error of ``IntegrationSolver.create_filter``
  (both ``dx`` and ``ddx`` exactly zero at an active bound) does not raise
  here: the variable is left free;
- ``path_dist`` adds the distance to the event point before its clip into
  the box (the flat engine adds it after the clip).
"""

from typing import Any, NamedTuple

import torch

from ..iterate import evaluate_iterate, is_feasible, locally_infeasible
from ..status import RUNNING, SolverStatus
from ..util import any_running, lanes, masked_while, select
from . import events as ev
from . import flow as fl
from .integrator import BISECT_BLOWUP, BISECT_RTOL, READ_EVERY

MAX_BISECT = 50


class DeviceLoopResult(NamedTuple):
    z: Any
    status: Any  # SolverStatus value
    iterations: Any
    rho: Any
    num_steps: Any
    num_newtons: Any
    path_dist: Any


def _create_filter(ctx, lb, ub, z, rho, every=0):
    """Traced counterpart of ``IntegrationSolver.create_filter``: the
    free-variable mask from active bounds and flow signs with second-order
    tie-breaks, never raising.  With ``every`` the second-order term is
    evaluated only when the host reads an ambiguous bound."""
    x, _ = fl.split(ctx, z)
    at_lb = fl.isclose(x, lb)
    at_ub = fl.isclose(x, ub)

    dx = -fl.aug_lag_deriv_x(ctx, z, rho)
    dx_zero = fl.isclose(dx, 0.0)

    fixed = (at_lb & (dx < 0)) | (at_ub & (dx > 0))

    amb_lb = at_lb & dx_zero
    amb_ub = at_ub & dx_zero
    if not every or any_running(amb_lb | amb_ub, "branch"):
        ddx = fl.rhs_deriv_x(ctx, z, rho)
        fixed = torch.where(amb_lb, ddx < 0, fixed)
        fixed = torch.where(amb_ub, ddx > 0, fixed)

    return ~fixed


def apply_event(ctx, fns, lb, ub, opt_tol, crossed, z_ev, filter, rho, status, every=0):
    """Dispatch the crossings ``crossed`` at the (clipped) event point
    ``z_ev`` in the reference's priority, the first crossed slot first
    (``integration_solver.py:143-225``): returns the new filter, status and
    rho.  The unboundedness event counts only at a feasible point."""
    n = ctx.n
    x_ev, y_ev = fl.split(ctx, z_ev)
    it = evaluate_iterate(fns, x_ev, y_ev)
    feas = is_feasible(it, lb, ub, opt_tol)
    unb_slot = torch.arange(crossed.shape[-1], device=crossed.device) == 3 * n + 1
    crossed = torch.where(unb_slot, crossed & lanes(feas, 1), crossed)

    has = crossed.any(dim=-1)
    idx = torch.argmax(crossed.to(torch.int8), dim=-1)  # first crossed slot

    is_pin = has & (idx < 2 * n)
    is_rel = has & (2 * n <= idx) & (idx < 3 * n)
    is_conv = has & (idx == 3 * n)
    is_unb = has & (idx == 3 * n + 1)
    is_pen = has & (idx == 3 * n + 2)

    cols = torch.arange(n, device=z_ev.device)
    pin_hot = cols == lanes(torch.where(is_pin, idx % n, 0), 1)
    rel_hot = cols == lanes(torch.where(is_rel, idx - 2 * n, 0), 1)
    filter_n = torch.where(lanes(is_pin, 1), filter & ~pin_hot, filter)
    filter_n = torch.where(lanes(is_rel, 1), filter_n | rel_hot, filter_n)

    status_n = torch.where(
        is_conv, int(SolverStatus.Optimal), torch.where(is_unb, int(SolverStatus.Unbounded), status)
    )
    rho_n = torch.where(is_pen, 10.0 * rho, rho)
    if not every or any_running(is_pen, "branch"):
        filter_n = torch.where(lanes(is_pen, 1), _create_filter(ctx, lb, ub, z_ev, rho_n, every), filter_n)
    return filter_n, status_n, rho_n


def termination(ctx, fns, lb, ub, params, z, filter, status):
    """The boundary checks of a segment start, in the host engine's order:
    Optimal, then LocallyInfeasible, then Unbounded, each only on a lane
    still running."""
    opt_tol = params.opt_tol
    res = fl.residuum(ctx, z, filter)
    it = evaluate_iterate(fns, *fl.split(ctx, z))
    infeas = locally_infeasible(it, lb, ub, params.active_tol, opt_tol, params.local_infeas_tol)
    unb = (it.obj <= params.obj_lower_limit) & is_feasible(it, lb, ub, opt_tol)
    status = torch.where((status == RUNNING) & (res <= opt_tol), int(SolverStatus.Optimal), status)
    status = torch.where((status == RUNNING) & infeas, int(SolverStatus.LocallyInfeasible), status)
    return torch.where((status == RUNNING) & unb, int(SolverStatus.Unbounded), status)


def make_device_loop(cfg, fns, lb, ub, params, run_segment, step_fn, every=READ_EVERY):
    """Build ``run(x, y) -> DeviceLoopResult``.

    ``run_segment``/``step_fn`` are the segment runner and single step of
    :func:`integrator.make_segment_runner`."""
    ctx = cfg.ctx
    n = ctx.n
    iteration_limit = params.iteration_limit or params.iteration_limit_default
    opt_tol = params.opt_tol
    every_loop = every or 1

    def run_vals(z, rho, filter, grad_dirs):
        return ev.event_values(cfg, z, rho, filter, grad_dirs)

    def bisect(t_prev, z_prev, t_cur, z_end, rho, filter, grad_dirs, active):
        """Bisection of the event bracket (``integrator.bisect_event``) on
        the lanes ``active``: ``z_end``, the segment's own accepted state at
        ``t_cur``, is the fallback when the bisection never re-finds the
        crossing, and a probe whose flow residuum blows past
        ``BISECT_BLOWUP`` times the bracket entry's stops it like a failed
        probe."""
        dirs = ev.event_directions(cfg, filter, grad_dirs)
        vals0 = run_vals(z_prev, rho, filter, grad_dirs)
        res_entry = vals0[..., 3 * n] + opt_tol  # conv slot = residuum - tol

        def cond(c):
            gap = c["t_hi"] - c["t_lo"]
            return (c["i"] < MAX_BISECT) & ~c["stop"] & (gap > BISECT_RTOL * torch.clamp(torch.abs(c["t_hi"]), min=1.0))

        def body(c):
            t_mid = 0.5 * (c["t_lo"] + c["t_hi"])
            h = t_mid - c["t_lo"]
            z_mid, ok = step_fn(c["z_lo"], h, rho, filter)
            vals_mid = run_vals(z_mid, rho, filter, grad_dirs)
            res_mid = vals_mid[..., 3 * n] + opt_tol
            ok = ok & torch.isfinite(res_mid) & (res_mid <= BISECT_BLOWUP * res_entry)
            crossed = ev.crossings(c["vals_lo"], vals_mid, dirs).any(dim=-1)
            hi_branch = ok & crossed
            lo_branch = ok & ~crossed
            lo1, hi1 = lanes(lo_branch, 1), lanes(hi_branch, 1)
            return dict(
                t_lo=torch.where(lo_branch, t_mid, c["t_lo"]),
                z_lo=torch.where(lo1, z_mid, c["z_lo"]),
                vals_lo=torch.where(lo1, vals_mid, c["vals_lo"]),
                t_hi=torch.where(hi_branch, t_mid, c["t_hi"]),
                z_hi=torch.where(hi1, z_mid, c["z_hi"]),
                has_hi=c["has_hi"] | hi_branch,
                stop=~ok,
                i=c["i"] + 1,
            )

        init = dict(
            t_lo=t_prev,
            z_lo=z_prev,
            vals_lo=vals0,
            t_hi=t_cur,
            z_hi=torch.zeros_like(z_prev),
            has_hi=torch.zeros_like(active),
            stop=~active,
            i=torch.zeros_like(t_prev, dtype=torch.int64),
        )
        out = masked_while(cond, body, init, every, "bisect", MAX_BISECT)

        z_hi = torch.where(lanes(out["has_hi"], 1), out["z_hi"], z_end)
        vals_hi = run_vals(z_hi, rho, filter, grad_dirs)
        crossed = ev.crossings(out["vals_lo"], vals_hi, dirs)
        return out["t_hi"], z_hi, crossed

    def handle_event(z, h0, rho, filter, status, path_dist, seg, active):
        """Bisect to the crossing and dispatch it.  A pure-convergence
        crossing (conv the only crossed event of the step) skips the
        bisection: the segment's accepted endpoint certifies Optimal."""
        grad_dirs = ev.grad_event_dirs(ctx, z, filter, lb, ub)
        conv_only = seg.crossed[..., 3 * n] & (seg.crossed.sum(dim=-1) == 1)
        t_b, z_b, crossed_b = bisect(
            seg.t_prev, seg.z_prev, seg.t, seg.z, rho, filter, grad_dirs, active & ~conv_only
        )
        t_ev = torch.where(conv_only, seg.t, t_b)
        z_ev = torch.where(lanes(conv_only, 1), seg.z, z_b)
        crossed = torch.where(lanes(conv_only, 1), seg.crossed, crossed_b)
        path_dist = path_dist + fl.norm(z_ev - z)

        # clip into the box (reference integration_solver.py:330)
        x_ev, y_ev = fl.split(ctx, z_ev)
        z_ev = torch.cat([torch.clamp(x_ev, lb, ub), y_ev], dim=-1)

        filter_n, status_n, rho_n = apply_event(
            ctx, fns, lb, ub, opt_tol, crossed, z_ev, filter, rho, status, every
        )
        # conservative restart after any event (dynamics changed)
        return t_ev, z_ev, torch.full_like(h0, 1e-4), rho_n, filter_n, status_n, path_dist

    def body(c):
        z, t, h0, rho, filter = c["z"], c["t"], c["h0"], c["rho"], c["filter"]
        status, path_dist = c["status"], c["path_dist"]

        # termination checks at segment boundaries (host engine order)
        status = termination(ctx, fns, lb, ub, params, z, filter, status)
        ran = status == RUNNING  # boundary checks passed: a segment runs

        grad_dirs = ev.grad_event_dirs(ctx, z, filter, lb, ub)
        seg = run_segment(t, z, h0, rho, filter, grad_dirs, t + 1e10, active=ran)
        is_event = seg.status == 0
        on_event = handle_event(z, h0, rho, filter, status, path_dist, seg, ran & is_event)
        on_t_end = (
            seg.t, seg.z, torch.clamp(seg.h, min=1e-10), rho, filter, status, path_dist + fl.norm(seg.z - z),
        )
        t_n, z_n, h_n, rho_n, filter_n, status_n, pd_n = select(is_event, on_event, on_t_end)
        # breakdown (status 2): stop with IterationLimit like the host
        brk = seg.status == 2
        status_n = torch.where(brk, int(SolverStatus.IterationLimit), status_n)
        z_n = torch.where(lanes(brk, 1), seg.z, z_n)

        new = (z_n, t_n, h_n, rho_n, filter_n, status_n, pd_n)
        z, t, h0, rho, filter, status, path_dist = select(ran, new, (z, t, h0, rho, filter, status, path_dist))

        # the host engine counts each segment run, including the one that
        # sets a terminal status, but not a boundary check's stop
        iteration = c["iteration"] + ran
        status = torch.where(
            (iteration >= iteration_limit) & (status == RUNNING), int(SolverStatus.IterationLimit), status
        )
        return dict(
            z=z, t=t, h0=h0, rho=rho, filter=filter, status=status, iteration=iteration, path_dist=path_dist,
            steps=c["steps"] + torch.where(ran, seg.num_steps, 0),
            newtons=c["newtons"] + torch.where(ran, seg.num_newton, 0),
        )

    def run(x, y):
        z = torch.cat([x, y], dim=-1)
        lead = z.shape[:-1]
        rho0 = torch.full(lead, params.rho, dtype=z.dtype, device=z.device)
        zero = torch.zeros(lead, dtype=torch.int64, device=z.device)
        init = dict(
            z=z,
            t=torch.zeros(lead, dtype=z.dtype, device=z.device),
            h0=torch.full(lead, 1e-4, dtype=z.dtype, device=z.device),
            rho=rho0,
            filter=_create_filter(ctx, lb, ub, z, rho0, every),
            status=torch.full(lead, RUNNING, dtype=torch.int64, device=z.device),
            iteration=zero,
            path_dist=torch.zeros(lead, dtype=z.dtype, device=z.device),
            steps=zero,
            newtons=zero,
        )
        out = masked_while(lambda c: c["status"] == RUNNING, body, init, every_loop, "device_loop")
        return DeviceLoopResult(
            z=out["z"],
            status=out["status"],
            iterations=out["iteration"],
            rho=out["rho"],
            num_steps=out["steps"],
            num_newtons=out["newtons"],
            path_dist=out["path_dist"],
        )

    return run
