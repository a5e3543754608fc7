"""Continuous-flow solver with event detection (counterpart of
``pygradflow_tpu/integration/integration_solver.py``).

Instead of discrete implicit-Euler steps, integrate the restricted
augmented-Lagrangian gradient flow (free variables move, pinned variables
stay at their bounds) until an event: a free variable hitting a bound, a
pinned variable's gradient changing sign, convergence, unboundedness, or
the penalty continuation criterion.  Then flip the filter bit or grow rho
and continue.

Three engines take the same decisions:
- the host engine (the default): the event loop is host Python, each
  segment a masked step loop (``integrator.make_segment_runner``), each
  event located by host-driven bisection;
- the device engine (``params.integration_device_loop`` with an infinite
  ``time_limit``): the whole solve as one loop over tensors
  (``device_loop.py``);
- the flat engine (``integration_device_loop`` with a finite
  ``time_limit``): uniform work units in chunks of
  ``params.integration_chunk``, the time limit checked between chunks
  (``flat_loop.py``).
On a CUDA device each step attempt, bisection probe and work unit replays
CUDA graphs (``integrator.graph_pair``, ``batch.FlatRunner``).
``collect_path`` and ``display`` take the host engine, which logs one
row per segment (``display.integrator_display``).
"""

import math
from typing import Optional

import numpy as np
import torch

from ..display import integrator_display, print_problem_stats
from ..eval import validate_fns
from ..iterate import bounds_dual, evaluate_iterate, is_feasible, locally_infeasible
from ..log import logger
from ..params import Params
from ..result import SolverResult
from ..solver import _resolve_device
from ..status import RUNNING, SolverStatus  # noqa: F401
from ..timer import Timer
from ..transform import Transformation
from . import events as ev
from . import flow as fl
from . import integrator
from .integrator import bisect_event, make_segment_runner


class IntegrationSolver:
    """User-facing continuous solver.  ``device`` is chosen once, here:
    without one the solve runs on the current CUDA device, and the
    constructor raises ``RuntimeError`` when there is no card (CPU use
    passes ``device="cpu"``).  The masked loops that run eagerly read on the
    host every ``integrator.READ_EVERY`` iterations; the cadence does not
    change the result."""

    def __init__(self, problem, params: Optional[Params] = None, device=None):
        if params is None:
            params = Params()
        self.orig_problem = problem
        self.params = params
        self.device = _resolve_device(device)
        self.every = integrator.READ_EVERY

        self.transform = Transformation(problem, params, self.device)
        self.problem = self.transform.trans_problem
        self.fns = self.transform.fns

        dtype = params.dtype
        self.lb = torch.as_tensor(self.problem.var_lb, dtype=dtype, device=self.device)
        self.ub = torch.as_tensor(self.problem.var_ub, dtype=dtype, device=self.device)
        self.ctx = fl.FlowCtx(fns=self.fns, lb=self.lb, ub=self.ub)
        self.cfg = ev.EventCfg(
            ctx=self.ctx,
            opt_tol=params.opt_tol,
            obj_lower_limit=params.obj_lower_limit,
            active_tol=params.active_tol,
        )

        self._run_segment, self._step_fn = make_segment_runner(
            self.cfg,
            method=params.integration_method,
            rtol=params.integration_rtol,
            atol=params.integration_atol,
            max_steps=params.integration_max_steps,
            every=self.every,
        )

    # ------------------------------------------------------------------

    def create_filter(self, z, rho):
        """Free-variable mask from active bounds and flow signs, with
        second-order tie-breaks (reference ``integration_solver.py:90-123``);
        raises "Degenerate bound" when both are zero at an active bound."""
        ctx = self.ctx
        x, _ = fl.split(ctx, z)
        at_lb = fl.isclose(x, self.lb).cpu().numpy()
        at_ub = fl.isclose(x, self.ub).cpu().numpy()

        dx_t = -fl.aug_lag_deriv_x(ctx, z, rho)
        dx = dx_t.cpu().numpy()
        dx_zero = fl.isclose(dx_t, 0.0).cpu().numpy()

        fixed = np.logical_or(np.logical_and(at_lb, dx < 0), np.logical_and(at_ub, dx > 0))

        ambiguous = np.logical_and(dx_zero, np.logical_or(at_lb, at_ub))
        if ambiguous.any():
            ddx_t = fl.rhs_deriv_x(ctx, z, rho)
            ddx = ddx_t.cpu().numpy()
            if fl.isclose(ddx_t[torch.as_tensor(ambiguous, device=z.device)], 0.0).any():
                raise Exception("Degenerate bound")
            amb_lb = np.logical_and(at_lb, dx_zero)
            fixed[amb_lb] = ddx[amb_lb] < 0
            amb_ub = np.logical_and(at_ub, dx_zero)
            fixed[amb_ub] = ddx[amb_ub] > 0

        return torch.as_tensor(np.logical_not(fixed), device=z.device)

    # ------------------------------------------------------------------

    def solve(self, x0=None, y0=None) -> SolverResult:
        params = self.params
        problem = self.problem
        n = self.ctx.n

        x, y = self.transform.create_transformed_initial(x0, y0, self.device)
        if params.validate_input:
            validate_fns(self.fns, x, y)

        if params.integration_device_loop and not params.collect_path and not params.display:
            return self._solve_device(x, y)

        print_problem_stats(problem, problem.num_vars, problem.num_cons)

        rho = params.rho
        z = torch.cat([x, y])
        t = 0.0
        h0 = 1e-4  # carried across segments once the controller adapts it
        filter = self.create_filter(z, rho)

        z_init = z
        status = None
        iteration = 0
        path_dist = 0.0
        total_steps = 0
        total_newtons = 0

        path = [z] if params.collect_path else None
        path_times = [0.0] if params.collect_path else None

        timer = Timer(params.time_limit)
        iteration_limit = params.iteration_limit or params.iteration_limit_default
        display = integrator_display(self.ctx.m, params) if params.display else None

        def scalar(v):
            return torch.tensor(v, dtype=z.dtype, device=z.device)

        while True:
            res = float(fl.residuum(self.ctx, z, filter))
            if res <= params.opt_tol:
                status = SolverStatus.Optimal
                break

            if timer.reached_time_limit():
                status = SolverStatus.TimeLimit
                break

            it = evaluate_iterate(self.fns, *fl.split(self.ctx, z))
            infeas = locally_infeasible(
                it, self.lb, self.ub, params.active_tol, params.opt_tol, params.local_infeas_tol
            )
            if bool(infeas):
                status = SolverStatus.LocallyInfeasible
                break
            if bool(it.obj <= params.obj_lower_limit) and bool(is_feasible(it, self.lb, self.ub, params.opt_tol)):
                status = SolverStatus.Unbounded
                break

            grad_dirs = ev.grad_event_dirs(self.ctx, z, filter, self.lb, self.ub)
            t_end = t + 1e10

            seg = self._run_segment(scalar(t), z, scalar(h0), rho, filter, grad_dirs, scalar(t_end))

            seg_status = int(seg.status)
            iteration += 1
            total_steps += int(seg.num_steps)
            total_newtons += int(seg.num_newton)
            # carry the adapted step when the segment merely ran out of
            # horizon (t_end); after a real event the filter or rho changes
            # the dynamics, so restart conservatively
            h0 = max(float(seg.h), 1e-10) if seg_status == 1 else 1e-4

            if display is not None and display.should_display():
                values = [seg.t, fl.obj(self.ctx, seg.z), fl.residuum(self.ctx, seg.z, filter), filter.sum()]
                t_seg, obj, res_seg, free = torch.stack([v.to(torch.float64) for v in values]).tolist()
                display.row(
                    dict(iter=iteration, t=t_seg, obj=obj, res=res_seg, rho=rho,
                         steps=int(seg.num_steps), free=int(free))
                )

            if seg_status == 2:
                # integrator breakdown: treat as a failed solve
                logger.warning("Integrator failed to advance at t=%s", float(seg.t))
                status = SolverStatus.IterationLimit
                z = seg.z
                break

            if seg_status == 0:
                crossed_step = seg.crossed.cpu().numpy()
                if bool(crossed_step[3 * n]) and crossed_step.sum() == 1:
                    # pure-convergence crossing: any point past it has
                    # residuum <= opt_tol, so the segment's accepted endpoint
                    # certifies Optimal (the other engines do the same)
                    t_ev, z_ev, crossed = float(seg.t), seg.z, crossed_step
                else:
                    # refine the event location by bisection
                    def run_vals(zz):
                        return ev.event_values(self.cfg, zz, rho, filter, grad_dirs)

                    t_ev, z_ev, crossed = bisect_event(
                        self.cfg,
                        self._step_fn,
                        run_vals,
                        seg.t_prev,
                        seg.z_prev,
                        float(seg.t),
                        rho,
                        filter,
                        grad_dirs,
                        z_end=seg.z,
                    )
                    crossed = crossed.cpu().numpy()
                path_dist += float(fl.norm(z_ev - z))
                t, z = t_ev, z_ev

                # clip into the box (reference integration_solver.py:330)
                xz, yz = fl.split(self.ctx, z)
                z = torch.cat([torch.clamp(xz, self.lb, self.ub), yz])

                if path is not None:
                    path.append(z)
                    path_times.append(t)

                handled = self._handle_crossings(crossed, z, rho, filter)
                if handled is not None:
                    kind, payload = handled
                    if kind == "status":
                        status = payload
                        break
                    elif kind == "filter":
                        filter = payload
                    else:
                        assert kind == "penalty"
                        logger.debug("Penalty event: rho %e -> %e", rho, 10.0 * rho)
                        rho = 10.0 * rho
                        filter = self.create_filter(z, rho)
                # else: e.g. an unbounded event at an infeasible point: resume
            else:
                # reached t_end without an event
                path_dist += float(fl.norm(seg.z - z))
                t, z = float(seg.t), seg.z
                if path is not None:
                    path.append(z)
                    path_times.append(t)

            if iteration >= iteration_limit:
                status = SolverStatus.IterationLimit
                break

        it = evaluate_iterate(self.fns, *fl.split(self.ctx, z))
        d = bounds_dual(it, self.lb, self.ub, params.active_tol)

        direct_dist = float(fl.norm(z - z_init))
        dist_factor = path_dist / direct_dist if direct_dist != 0.0 else 1.0

        xr, yr, dr = self.transform.restore_sol(it.x, it.y, d)
        result = SolverResult(
            problem,
            xr,
            yr,
            dr,
            status,
            iterations=iteration,
            num_accepted_steps=iteration,
            total_time=timer.elapsed(),
            dist_factor=dist_factor,
            num_integration_steps=total_steps,
            num_newton_steps=total_newtons,
            final_rho=rho,
        )
        if path is not None:
            result._set_path(torch.stack(path, dim=1), torch.tensor(path_times, dtype=z.dtype, device=z.device))
        return result

    # ------------------------------------------------------------------

    def _result(self, x, y, z, status, iterations, steps, newtons, rho, path_dist, timer, **attrs):
        """The result of a device or flat solve ending at ``z``."""
        params = self.params
        xf, yf = fl.split(self.ctx, z)
        it = evaluate_iterate(self.fns, xf, yf)
        d = bounds_dual(it, self.lb, self.ub, params.active_tol)
        xr, yr, dr = self.transform.restore_sol(it.x, it.y, d)
        direct = float(fl.norm(z - torch.cat([x, y])))
        path_dist = float(path_dist)
        return SolverResult(
            self.problem,
            xr,
            yr,
            dr,
            SolverStatus(int(status)),
            iterations=int(iterations),
            num_accepted_steps=int(iterations),
            total_time=timer.elapsed(),
            dist_factor=path_dist / direct if direct != 0.0 else 1.0,
            num_integration_steps=int(steps),
            num_newton_steps=int(newtons),
            final_rho=float(rho),
            **attrs,
        )

    def _solve_device(self, x, y):
        """Device engine (``Params.integration_device_loop``): with
        ``time_limit=inf`` the whole solve is one device loop; with a finite
        limit the flat engine runs in chunks of ``params.integration_chunk``
        work units, the Timer checked between chunks."""
        params = self.params
        timer = Timer(params.time_limit)

        if math.isfinite(params.time_limit):
            return self._solve_device_chunked(x, y, timer)

        from .device_loop import make_device_loop

        loop = make_device_loop(
            self.cfg, self.fns, self.lb, self.ub, params, self._run_segment, self._step_fn, self.every
        )
        res = loop(x, y)
        return self._result(
            x, y, res.z, res.status, res.iterations, res.num_steps, res.num_newtons, res.rho, res.path_dist, timer
        )

    def _solve_device_chunked(self, x, y, timer):
        """Flat chunked engine: ``time_limit`` enforced at chunk boundaries."""
        from .batch import FlatRunner

        runner = FlatRunner(self.cfg, self.fns, self.lb, self.ub, self.params, self.every)
        state = runner.run(runner.init(x, y), timer)
        return self._result(
            x, y, state["z"], state["status"], state["iteration"], state["steps"], state["newtons"],
            state["rho"], state["path_dist"], timer, num_work_units=int(state["units"]),
        )

    # ------------------------------------------------------------------

    def _handle_crossings(self, crossed, z, rho, filter):
        """Reference ``handle_events`` (``integration_solver.py:143-225``):
        process crossings in priority order."""
        n = self.ctx.n
        params = self.params

        for idx in np.where(crossed)[0]:
            if idx < 2 * n:
                j = idx % n
                logger.debug("Variable %d hit a bound; pinning", j)
                filter = filter.clone()
                filter[j] = False
                return ("filter", filter)
            elif idx < 3 * n:
                j = idx - 2 * n
                logger.debug("Pinned variable %d released", j)
                filter = filter.clone()
                filter[j] = True
                return ("filter", filter)
            elif idx == 3 * n:
                return ("status", SolverStatus.Optimal)
            elif idx == 3 * n + 1:
                it = evaluate_iterate(self.fns, *fl.split(self.ctx, z))
                if bool(is_feasible(it, self.lb, self.ub, params.opt_tol)):
                    return ("status", SolverStatus.Unbounded)
                continue  # infeasible: keep scanning other events
            else:
                return ("penalty", None)
        return None
