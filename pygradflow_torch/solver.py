"""The solve loop: implicit-Euler homotopy steps (counterpart of
``pygradflow_tpu/solver.py``).

The JAX package runs the loop as ``lax.while_loop`` chunks with masked,
branchless state updates.  Here it is an eager Python loop that takes the
same decisions in the same order: termination in the reference's priority
(``check_terminate``), then one step with its penalty update and veto
(``run_iteration``).  Scalars of the state are Python numbers, so each
iteration synchronises with the device a few times; capturing the loop in
a CUDA graph is later work.  Lambda, rho, the PI sum and the path length
are rounded to the solve's precision at each operation
(``params.scalar_type``), as the JAX package's 0-dim arrays of
``params.dtype`` are.  The rcond estimate of the last step stays on the
device until the solve ends.  With ``params.collect_path`` the accepted
iterates go into a ring of ``path_capacity`` columns on the solver's
device, with model times ``t += 1/lambda``.

The loop is cut into chunks of ``params.jit_chunk`` iterations, where the
JAX package returns to the host: the time limit is checked there, and a
``checkpoint.CheckpointManager`` writes its snapshot.  ``params.display``
logs one row per iteration (``display.solver_display``), at the cost of one
more host read when a row is shown.
"""

import os
import time
from typing import Any, NamedTuple

import torch

from .callbacks import Callbacks, CallbackType
from .deriv_check import deriv_check_problem
from .display import Format, print_problem_stats, solver_display
from .eval import Counters, EvalError, diagnose_eval_failure, validate_fns
from .iterate import (
    Iterate,
    aug_lag,
    bounds_dual,
    cons_violation,
    evaluate_iterate,
    is_feasible,
    iterate_eval_counts,
    locally_infeasible,
    obj_nonlin,
    stat_res,
    total_res,
)
from .log import logger
from .params import Params, PenaltyUpdate
from .penalty import penalty_strategy
from .problem import Problem
from .result import SolverResult
from .status import RUNNING, SolverStatus
from .step.control import compute_step, make_control_cfg, make_controller
from .timer import Timer
from .transform import Transformation


class LoopState(NamedTuple):
    it: Iterate
    lamb: float
    rho: float
    error_sum: float
    pstate: Any
    iteration: int
    accepted_steps: int
    num_penalty_changes: int
    path_dist: float
    status: int
    counters: Counters
    # () or, under params.validate_input, (flag, first_x, first_y, cand_x,
    # cand_y): whether a candidate was rejected for non-finite values, and
    # the first such, kept for the eval diagnosis
    eval_fail: tuple
    rcond: Any = float("nan")  # estimate of the most recent step
    # () or (buffer (cap, n+m), times (cap,), length): params.collect_path
    path: tuple = ()


class SolveLoop:
    """The solve loop for one (problem, params) pair on one device."""

    def __init__(self, transform: Transformation, params: Params, device, callbacks=None):
        self.transform = transform
        self.params = params
        self.fns = transform.fns
        self.callbacks = callbacks

        problem = transform.trans_problem
        self.n = problem.num_vars
        self.m = problem.num_cons
        self.lb = torch.as_tensor(problem.var_lb, dtype=params.dtype, device=device)
        self.ub = torch.as_tensor(problem.var_ub, dtype=params.dtype, device=device)

        self.cfg = make_control_cfg(self.fns, params, self.lb, self.ub)
        self.controller = make_controller(self.cfg)
        self.penalty_initial, self.penalty_update = penalty_strategy(params, self.m, self.fns, device)

        if params.iteration_limit is not None:
            self.iteration_limit = int(params.iteration_limit)
        else:
            self.iteration_limit = int(params.iteration_limit_default)
        self.display = solver_display(self.m, params) if params.display else None

    def init_state(self, x, y) -> LoopState:
        params = self.params
        f = params.scalar_type
        rho0, pstate0 = self.penalty_initial()
        path = ()
        if params.collect_path:
            cap = params.path_capacity
            buf = torch.zeros((cap, self.n + self.m), dtype=x.dtype, device=x.device)
            buf[0] = torch.cat([x, y])
            path = (buf, torch.zeros(cap, dtype=x.dtype, device=x.device), 1)
        eval_fail = ()
        if params.validate_input:
            zx, zy = torch.zeros_like(x), torch.zeros_like(y)
            eval_fail = (False, zx, zy, zx, zy)
        return LoopState(
            it=evaluate_iterate(self.fns, x, y),
            lamb=float(f(params.lamb_init)),
            rho=float(f(rho0)),
            error_sum=0.0,
            pstate=pstate0,
            iteration=0,
            accepted_steps=0,
            num_penalty_changes=0,
            path_dist=0.0,
            status=RUNNING,
            counters=Counters.zero().add(**iterate_eval_counts(self.m)),
            eval_fail=eval_fail,
            path=path,
        )

    def check_terminate(self, state: LoopState) -> int:
        """Termination in the reference's priority (``solver.py:180-205``):
        a later test overrides an earlier one."""
        params = self.params
        it = state.it
        lb, ub = self.lb, self.ub

        unbounded = (it.obj <= params.obj_lower_limit) & is_feasible(it, lb, ub, params.opt_tol)
        infeas = locally_infeasible(
            it, lb, ub, params.active_tol, params.opt_tol, params.local_infeas_tol, self.fns
        )
        optimal = total_res(it, lb, ub, params.active_tol, self.fns) <= params.opt_tol
        unbounded, infeas, optimal = torch.stack([unbounded, infeas, optimal]).tolist()

        status = RUNNING
        if unbounded:
            status = int(SolverStatus.Unbounded)
        if infeas:
            status = int(SolverStatus.LocallyInfeasible)
        if optimal:
            status = int(SolverStatus.Optimal)
        if state.iteration >= self.iteration_limit:
            status = int(SolverStatus.IterationLimit)
        return status

    def run_iteration(self, state: LoopState) -> LoopState:
        """One outer iteration (reference ``solver.py:305-380``)."""
        out = compute_step(
            self.cfg, self.controller, state.it, state.lamb, state.rho,
            state.error_sum, state.counters,
        )
        ctrl = out.ctrl
        next_it = ctrl.iterate

        # the penalty update runs on every candidate, applies only to
        # accepted steps and can veto them (reference solver.py:357-369)
        pres = self.penalty_update(state.it, next_it, state.rho, state.pstate)
        accept = ctrl.accepted and pres.accept
        pstate_n = pres.state if ctrl.accepted else state.pstate
        rho_n = pres.rho if accept else state.rho

        f = self.params.scalar_type
        path_dist = state.path_dist
        if accept:
            primal, dual = torch.stack(
                [torch.linalg.vector_norm(next_it.x - state.it.x),
                 torch.linalg.vector_norm(next_it.y - state.it.y)]
            ).tolist()
            path_dist = float(f(path_dist) + (f(primal) + f(dual)))

        eval_fail = state.eval_fail
        if eval_fail and not out.eval_ok and not eval_fail[0]:
            eval_fail = (True, out.first_x, out.first_y, out.cand_x, out.cand_y)

        if self.callbacks is not None and not self.callbacks.empty(CallbackType.ComputedStep):
            self.callbacks(
                CallbackType.ComputedStep,
                (state.it.x, state.it.y),
                (next_it.x, next_it.y),
                accept,
            )

        path = state.path
        if path and accept and path[2] < self.params.path_capacity:
            buf, times, length = path
            buf[length] = torch.cat([next_it.x, next_it.y])
            times[length] = times[length - 1] + 1.0 / ctrl.lamb
            path = (buf, times, length + 1)

        # lambda blow-up (the reference raises, solver.py:323-326)
        status = int(SolverStatus.LambdaLimit) if f(ctrl.lamb) >= f(self.params.lamb_max) else RUNNING
        state_n = LoopState(
            it=next_it if accept else state.it,
            lamb=ctrl.lamb,
            rho=rho_n,
            error_sum=ctrl.error_sum,
            pstate=pstate_n,
            iteration=state.iteration + 1,
            accepted_steps=state.accepted_steps + int(accept),
            num_penalty_changes=state.num_penalty_changes + int(accept and rho_n != state.rho),
            path_dist=path_dist,
            status=status,
            counters=ctrl.counters,
            eval_fail=eval_fail,
            rcond=ctrl.rcond,
            path=path,
        )
        if self.display is not None and self.display.should_display():
            self._emit_row(state, state_n, ctrl, accept)
        return state_n

    def _emit_row(self, state: LoopState, state_n: LoopState, ctrl, accept: bool) -> None:
        """One display row (reference ``solver.py:288-343``): the values of
        the iterate the step started from, the step to the candidate, and
        the new lambda and rho; one host read."""
        params = self.params
        it, cand = state.it, ctrl.iterate
        names = ["aug_lag", "obj", "cons_viol", "stat_res", "active", "obj_nonlin", "|dx|", "|dy|"]
        values = [
            aug_lag(it, state.rho),
            it.obj,
            cons_violation(it),
            stat_res(it, self.lb, self.ub, params.active_tol, self.fns),
            ctrl.active_set.sum(),
            obj_nonlin(it, cand),
            torch.linalg.vector_norm(cand.x - it.x),
            torch.linalg.vector_norm(cand.y - it.y),
        ]
        if params.report_rcond:
            names.append("rcond")
            values.append(ctrl.rcond)
        values = [torch.as_tensor(v, dtype=torch.float64, device=it.x.device) for v in values]
        row = dict(zip(names, torch.stack(values).tolist()))
        row.update(iter=state.iteration + 1, active=int(row["active"]), lamb=state_n.lamb, rho=state_n.rho, accept=accept)
        self.display.row(row)

    def run(self, state: LoopState, timer: Timer, ckpt=None) -> LoopState:
        """Iterate until a terminal status.  Every ``jit_chunk`` iterations
        from the state given, where the JAX package returns to the host,
        ``ckpt`` (a ``checkpoint.CheckpointManager``) may write a snapshot
        and the time limit is checked."""
        chunk = self.params.jit_chunk
        chunk_end = state.iteration + chunk
        while True:
            status = self.check_terminate(state)
            if status != RUNNING:
                return state._replace(status=status)
            state = self.run_iteration(state)
            if state.status != RUNNING:
                return state
            if state.iteration >= chunk_end:
                chunk_end += chunk
                if ckpt is not None:
                    ckpt.maybe_save(state)
                if timer.reached_time_limit():
                    return state._replace(status=int(SolverStatus.TimeLimit))


def _profiled(fn, trace_dir: str, device: torch.device):
    """``fn()`` under ``torch.profiler``, with the card's activity when the
    solve runs there; the Chrome trace goes into ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"solve_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
    return out


def _resolve_device(device) -> torch.device:
    """The device of a solve: ``None`` means the current CUDA device, and
    raises when there is none; the CPU only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pygradflow_torch runs on the card by default; "
                'pass device="cpu" to solve on the CPU'
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Solver:
    """User-facing solver (reference ``pygradflow/solver.py:26-431``).

    ``device`` is chosen once, here; every tensor of a solve lives there.
    Without one the solve runs on the current CUDA device, and the
    constructor raises ``RuntimeError`` when there is no card: CPU use
    passes ``device="cpu"``.  Initial points may be numpy arrays or tensors
    on that device.
    """

    def __init__(self, problem: Problem, params: Params = None, device=None) -> None:
        if params is None:
            params = Params()
        self.orig_problem = problem
        self.params = params
        self.device = _resolve_device(device)
        self.callbacks = Callbacks()

        self.transform = Transformation(problem, params, self.device)
        self.problem = self.transform.trans_problem
        self.evaluator = self.transform.fns

        self._loop = SolveLoop(self.transform, params, self.device, self.callbacks)

    def perform_iteration(self, x0=None, y0=None):
        """One implicit-Euler step from ``(x0, y0)`` at the initial lambda
        and rho (reference ``solver.py:207-231``); returns ``(x, y, d)`` of
        the iterate after the step, the start itself when the step was
        rejected, as tensors on the solver's device."""
        params = self.params
        loop = self._loop

        x, y = self.transform.create_transformed_initial(x0, y0, self.device)
        state = loop.init_state(x, y)
        state = loop.run_iteration(state)

        it = state.it
        d = bounds_dual(it, loop.lb, loop.ub, params.active_tol, loop.fns)
        return self.transform.restore_sol(it.x, it.y, d)

    def solve(self, x0=None, y0=None, checkpoint_path=None, resume=False) -> SolverResult:
        """Solve the problem.  With ``checkpoint_path`` the loop state is
        written there (``checkpoint.py``) every ``jit_chunk`` iterations;
        ``resume=True`` starts from the snapshot found there, and the solve
        goes on bit for bit as the uninterrupted one would.  A snapshot of
        the JAX package's loop resumes here too.  ``params.profile_dir``
        traces the solve with ``torch.profiler`` into that directory."""
        params = self.params
        loop = self._loop

        x, y = self.transform.create_transformed_initial(x0, y0, self.device)

        if params.validate_input:
            try:
                validate_fns(self.transform.fns, x, y)
            except EvalError as e:
                raise Exception("Failed to evaluate initial iterate") from e

        print_problem_stats(self.problem, loop.n, loop.m)

        deriv_check_problem(self.problem, params, x, y)

        timer = Timer(params.time_limit)

        ckpt = None
        if checkpoint_path is not None:
            from .checkpoint import CheckpointManager

            ckpt = CheckpointManager(checkpoint_path)

        def drive():
            state0 = loop.init_state(x, y)
            if ckpt is not None and resume and ckpt.exists():
                state0 = ckpt.restore(state0)
            return loop.run(state0, timer, ckpt)

        if params.profile_dir:
            state = _profiled(drive, params.profile_dir, self.device)
        else:
            state = drive()
        total_time = timer.elapsed()
        status = SolverStatus(state.status)

        failed_component, fail_x = None, None
        if state.eval_fail and state.eval_fail[0]:
            # replay the user callbacks at the first rejected candidate,
            # then at the final one, and name the one that failed
            first_x, first_y, cand_x, cand_y = state.eval_fail[1:]
            for fail_x, fail_y in ((first_x, first_y), (cand_x, cand_y)):
                failed_component = diagnose_eval_failure(self.transform.fns, fail_x, fail_y)
                if failed_component is not None:
                    break
            if failed_component is not None:
                logger.warning(
                    "Evaluation of %s produced non-finite values at x = %s (step rejected)",
                    failed_component.name(),
                    fail_x.cpu().numpy(),
                )

        if status == SolverStatus.LambdaLimit:
            if failed_component is not None:
                raise EvalError(
                    f"Evaluation of {failed_component.name()} produced "
                    f"non-finite values at x = {fail_x.cpu().numpy()}",
                    fail_x,
                )
            raise Exception(
                f"Inverse step size {state.lamb} exceeded maximum "
                f"{params.lamb_max} (incorrect derivatives?)"
            )

        it = state.it
        d = bounds_dual(it, loop.lb, loop.ub, params.active_tol, loop.fns)
        direct_dist, final_stat_res, final_cons_violation, final_obj = torch.stack(
            [
                torch.sqrt(torch.sum((it.x - x) ** 2) + torch.sum((it.y - y) ** 2)),
                stat_res(it, loop.lb, loop.ub, params.active_tol, loop.fns),
                cons_violation(it),
                it.obj,
            ]
        ).tolist()
        x_r, y_r, d_r = self.transform.restore_sol(it.x, it.y, d)
        dist_factor = state.path_dist / direct_dist if direct_dist != 0.0 else 1.0
        num_evals = state.counters.as_dict()

        self._print_result(
            total_time=total_time,
            status=status,
            iterations=state.iteration,
            accepted_steps=state.accepted_steps,
            penalty_changes=state.num_penalty_changes,
            rho=state.rho,
            dist_factor=dist_factor,
            final_obj=final_obj,
            final_stat_res=final_stat_res,
            final_cons_violation=final_cons_violation,
            num_evals=num_evals,
        )

        result = SolverResult(
            self.problem,
            x_r,
            y_r,
            d_r,
            status,
            iterations=state.iteration,
            num_accepted_steps=state.accepted_steps,
            total_time=total_time,
            dist_factor=dist_factor,
            final_scaled_obj=final_obj,
            final_stat_res=final_stat_res,
            final_cons_violation=final_cons_violation,
            num_penalty_changes=state.num_penalty_changes,
            num_evals=num_evals,
            final_rcond=float(state.rcond),
        )
        if params.collect_path:
            buf, times, length = state.path
            # the initial point and one column per accepted step, unless the
            # ring stopped at its capacity (the reference path is unbounded)
            if state.accepted_steps + 1 > length:
                logger.warning(
                    "Trajectory truncated: %d accepted steps exceed path_capacity=%d; "
                    "raise Params.path_capacity to record the full path",
                    state.accepted_steps,
                    params.path_capacity,
                )
            result._set_path(buf[:length].T, times[:length])
        return result

    def _print_result(
        self,
        total_time,
        status,
        iterations,
        accepted_steps,
        penalty_changes,
        rho,
        dist_factor,
        final_obj,
        final_stat_res,
        final_cons_violation,
        num_evals,
    ):
        desc = "{:>45s}".format(SolverStatus.description(status))
        status_desc = Format.redgreen(desc, SolverStatus.success(status), bold=True)
        status_name = Format.bold("{:>20s}".format("Status"))

        logger.info("%20s: %45s", status_name, status_desc)
        logger.info("%20s: %45s", "Time", f"{total_time:.2f}s")
        logger.info("%20s: %45d", "Iterations", iterations)
        logger.info("%20s: %45d", "Accepted steps", accepted_steps)
        logger.info("%20s: %45e", "Distance factor", dist_factor)

        if self.params.penalty_update != PenaltyUpdate.Constant:
            logger.info("%20s: %45e", "Final penalty", rho)
            logger.info("%20s: %45d", "Penalty changes", penalty_changes)

        logger.info("%20s: %45e", "Objective", final_obj)
        logger.info("%20s: %45e", "Constraint violation", final_cons_violation)
        logger.info("%20s: %45e", "Dual violation", final_stat_res)

        logger.info("%20s", Format.bold("{:>20s}".format("Evaluations")))
        for component, num in num_evals.items():
            logger.info("%20s: %45d", component.name(), num)
