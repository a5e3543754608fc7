"""The solve loop: implicit-Euler homotopy steps (counterpart of
``pygradflow_tpu/solver.py``).

The JAX package runs the loop as ``lax.while_loop`` chunks with masked,
branchless state updates.  Here it is an eager Python loop that takes the
same decisions in the same order: termination in the reference's priority
(``check_terminate``), then one step with its penalty update and veto
(``run_iteration``).  Scalars of the state are Python numbers, so each
iteration synchronises with the device a few times; capturing the loop in
a CUDA graph is later work.
"""

from typing import Any, NamedTuple, Optional

import torch

from .callbacks import Callbacks, CallbackType
from .display import Format, print_problem_stats
from .eval import Counters, EvalError, diagnose_eval_failure, validate_fns
from .iterate import (
    Iterate,
    bounds_dual,
    cons_violation,
    evaluate_iterate,
    is_feasible,
    iterate_eval_counts,
    locally_infeasible,
    stat_res,
    total_res,
)
from .log import logger
from .params import DerivCheck, Params, PenaltyUpdate, Precision
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
    # (first_x, first_y, cand_x, cand_y) of the first candidate rejected for
    # non-finite values, kept for the eval diagnosis (params.validate_input)
    eval_fail: Optional[tuple]


def _check_supported(params: Params) -> None:
    unported = [
        (params.precision != Precision.Double, "Precision.Single", "A7"),
        (params.collect_path, "collect_path", "A6"),
        (params.display, "the live display (params.display)", "A12"),
        (params.deriv_check != DerivCheck.NoCheck, "derivative checks", "A12"),
    ]
    for cond, what, item in unported:
        if cond:
            raise NotImplementedError(f"{what} is not yet ported (ROADMAP {item})")


class SolveLoop:
    """The solve loop for one (problem, params) pair on one device."""

    def __init__(self, transform: Transformation, params: Params, device, callbacks=None):
        _check_supported(params)
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
        self.penalty_initial, self.penalty_update = penalty_strategy(params, self.m)

        if params.iteration_limit is not None:
            self.iteration_limit = int(params.iteration_limit)
        else:
            self.iteration_limit = int(params.iteration_limit_default)

    def init_state(self, x, y) -> LoopState:
        rho0, pstate0 = self.penalty_initial()
        return LoopState(
            it=evaluate_iterate(self.fns, x, y),
            lamb=float(self.params.lamb_init),
            rho=float(rho0),
            error_sum=0.0,
            pstate=pstate0,
            iteration=0,
            accepted_steps=0,
            num_penalty_changes=0,
            path_dist=0.0,
            status=RUNNING,
            counters=Counters.zero().add(**iterate_eval_counts(self.m)),
            eval_fail=None,
        )

    def check_terminate(self, state: LoopState) -> int:
        """Termination in the reference's priority (``solver.py:180-205``):
        a later test overrides an earlier one."""
        params = self.params
        it = state.it
        lb, ub = self.lb, self.ub

        unbounded = (it.obj <= params.obj_lower_limit) & is_feasible(it, lb, ub, params.opt_tol)
        infeas = locally_infeasible(
            it, lb, ub, params.active_tol, params.opt_tol, params.local_infeas_tol
        )
        optimal = total_res(it, lb, ub, params.active_tol) <= params.opt_tol
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

        path_dist = state.path_dist
        if accept:
            primal, dual = torch.stack(
                [torch.linalg.vector_norm(next_it.x - state.it.x),
                 torch.linalg.vector_norm(next_it.y - state.it.y)]
            ).tolist()
            path_dist += primal + dual

        eval_fail = state.eval_fail
        if self.params.validate_input and not out.eval_ok and eval_fail is None:
            eval_fail = (out.first_x, out.first_y, out.cand_x, out.cand_y)

        if self.callbacks is not None and not self.callbacks.empty(CallbackType.ComputedStep):
            self.callbacks(
                CallbackType.ComputedStep,
                (state.it.x, state.it.y),
                (next_it.x, next_it.y),
                accept,
            )

        # lambda blow-up (the reference raises, solver.py:323-326)
        status = int(SolverStatus.LambdaLimit) if ctrl.lamb >= self.params.lamb_max else RUNNING
        return LoopState(
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
        )

    def run(self, state: LoopState, timer: Timer) -> LoopState:
        """Iterate until a terminal status; the time limit is checked every
        ``jit_chunk`` iterations, where the JAX package checks it."""
        chunk = self.params.jit_chunk
        while True:
            status = self.check_terminate(state)
            if status != RUNNING:
                return state._replace(status=status)
            state = self.run_iteration(state)
            if state.status != RUNNING:
                return state
            if state.iteration % chunk == 0 and timer.reached_time_limit():
                return state._replace(status=int(SolverStatus.TimeLimit))


def _resolve_device(device) -> torch.device:
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Solver:
    """User-facing solver (reference ``pygradflow/solver.py:26-431``).

    ``device`` is chosen once, here; every tensor of a solve lives there.
    Initial points may be numpy arrays or tensors on that device.
    """

    def __init__(self, problem: Problem, params: Params = None, device=None) -> None:
        if params is None:
            params = Params()
        self.orig_problem = problem
        self.params = params
        self.device = _resolve_device(device)
        self.callbacks = Callbacks()

        self.transform = Transformation(problem, params)
        self.problem = self.transform.trans_problem
        self.evaluator = self.transform.fns

        self._loop = SolveLoop(self.transform, params, self.device, self.callbacks)

    def solve(self, x0=None, y0=None, checkpoint_path=None, resume=False) -> SolverResult:
        if checkpoint_path is not None or resume:
            raise NotImplementedError("checkpointing is not yet ported (ROADMAP A12)")
        params = self.params
        loop = self._loop

        x, y = self.transform.create_transformed_initial(x0, y0, self.device)

        if params.validate_input:
            try:
                validate_fns(self.transform.fns, x, y)
            except EvalError as e:
                raise Exception("Failed to evaluate initial iterate") from e

        print_problem_stats(self.problem, loop.n, loop.m)

        timer = Timer(params.time_limit)
        state = loop.run(loop.init_state(x, y), timer)
        total_time = timer.elapsed()
        status = SolverStatus(state.status)

        failed_component, fail_x = None, None
        if state.eval_fail is not None:
            # replay the user callbacks at the first rejected candidate,
            # then at the final one, and name the one that failed
            first_x, first_y, cand_x, cand_y = state.eval_fail
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
        d = bounds_dual(it, loop.lb, loop.ub, params.active_tol)
        direct_dist, final_stat_res, final_cons_violation, final_obj = torch.stack(
            [
                torch.sqrt(torch.sum((it.x - x) ** 2) + torch.sum((it.y - y) ** 2)),
                stat_res(it, loop.lb, loop.ub, params.active_tol),
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

        return SolverResult(
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
            final_rcond=float("nan"),
        )

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
