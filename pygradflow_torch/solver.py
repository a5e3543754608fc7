"""The solve loop: implicit-Euler homotopy steps (counterpart of
``pygradflow_tpu/solver.py``).

As in the JAX package, the loop state is a small tree of tensors on the
solver's device (``LoopState``): the iterate, and lambda, rho, the PI sum,
the path length and the rcond estimate as 0-dim tensors of
``params.dtype``, the counts and the status as 0-dim int64 tensors; the
lockstep loop (``parallel/batch.py``) gives each a lane axis.

``ChunkLoop`` is what both loops share: the terminal tests in the
reference's priority (``check_terminate``), the step core with its penalty
update and veto (``step``), every decision a ``torch.where``; the route of
a solve call, decided at its start (``decide_route``); and a chunk of up
to ``params.jit_chunk`` bodies with its one host read (``run_chunk``,
``read``; ``util.HOST_READS["chunk"]``).  On the card the chunk replays
the body as a CUDA graph (``graphs.ChunkGraph``), stopped soon after the
status is terminal: the counterpart of the JAX package's
``lax.while_loop``.  On the CPU, or for a configuration in
``EAGER_ON_CARD``, the same body runs eagerly, checking the status before
each iteration: on the CPU that is no device read, on the card one
(``HOST_READS["eager"]``).  A body reads nothing on the host.

``SolveLoop`` adds the JAX body's order (the terminal tests, then one
iteration unless they end the solve; a terminal state passes through
unchanged), the ``eval_fail`` record, the path ring, the callbacks and the
display rows (``run_iteration``), and ``run_chunks``, whose read is the
status, the counts and the final residuals in one packed vector, the
finalizer fused into the read as in the JAX package's fused driver; the
time limit is checked there, and a ``checkpoint.CheckpointManager``
writes its snapshot.  On the graphed route a solve's start is a CUDA graph
too (``SolveLoop.graphed_start``): the start iterate and, under
``params.validate_input``, the input check's verdicts from one replay and
one host read (``HOST_READS["start"]``), in place of ``validate_fns``'s
eager evaluations and reads.

Lambda, rho, the PI sum and the path length round to the solve's
precision at each operation, as the JAX package's 0-dim arrays of
``params.dtype`` do.  With ``params.collect_path`` the accepted iterates
go into a ring of ``path_capacity`` columns on the solver's device, with
model times ``t += 1/lambda``.  ``params.display`` logs one row per
iteration (``display.solver_display``) at one host read per row shown.
"""

import contextlib
import os
import time
from typing import Any, NamedTuple

import torch

from .callbacks import Callbacks, CallbackType
from .deriv_check import deriv_check_problem
from .display import Format, print_problem_stats, solver_display
from .eval import Counters, EvalError, diagnose_eval_failure, validate_fns
from .graphs import ChunkGraph, capture, cuda_graphed
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
from .linalg import LinearSolverType
from .log import logger
from .params import Params, PenaltyUpdate, StepControlType
from .penalty import penalty_strategy
from .problem import Problem
from .result import SolverResult
from .status import RUNNING, SolverStatus
from .step.control import compute_step, make_control_cfg, make_controller
from .timer import Timer
from .transform import Transformation
from .util import (
    CAPTURES,
    HOST_READS,
    LAUNCH_SLOTS,
    STARTS,
    add_device_launches,
    begin_call,
    device_launches,
    select,
    span,
)


START_FLAGS = ("objective", "gradient", "constraints", "jacobian", "hessian", "symmetric")
"""The input check's verdicts in ``Start.flags``, in order: each
evaluation at the start is finite (``validate_fns``'s tests, in its order;
a problem without constraints passes their two), and the Lagrangian
Hessian is symmetric as ``torch.allclose(hess, hess.T, rtol=1e-5,
atol=1e-8)`` tests it."""


class Start(NamedTuple):
    """A solve's start (``SolveLoop.start``)."""

    it: Iterate
    flags: Any  # bool (len(START_FLAGS),), or None without params.validate_input
    # whether the evaluations have validate_fns's shapes: a Python bool,
    # fixed when the start is captured (True without params.validate_input)
    shaped: bool


class LoopState(NamedTuple):
    it: Iterate
    lamb: Any  # 0-dim tensors of params.dtype
    rho: Any
    error_sum: Any
    pstate: Any
    iteration: Any  # 0-dim int64 tensors
    accepted_steps: Any
    num_penalty_changes: Any
    path_dist: Any  # 0-dim, params.dtype
    status: Any  # 0-dim int64, a SolverStatus value
    counters: Counters  # 0-dim int64 tensors
    # () or, under params.validate_input, (flag, first_x, first_y, cand_x,
    # cand_y): whether a candidate was rejected for non-finite values, and
    # the first such, kept for the eval diagnosis
    eval_fail: tuple
    rcond: Any  # 0-dim, params.dtype: the estimate of the most recent step
    # () or (buffer (cap, n+m), times (cap,), length 0-dim int64):
    # params.collect_path
    path: tuple = ()


EAGER_ON_CARD = (
    (lambda p, cb, prob: p.display, "params.display: a display row reads the host in each iteration"),
    (lambda p, cb, prob: cb is not None and not cb.empty(CallbackType.ComputedStep),
     "a ComputedStep callback runs on the host in each iteration"),
    (lambda p, cb, prob: getattr(prob, "evaluates_on_host", False),
     "the problem evaluates on the host (evaluates_on_host: CUTEst's callbacks, --debug_nans's checks)"),
    (lambda p, cb, prob: p.step_control_type == StepControlType.BoxReduced,
     "BoxReduced: the box solver reads the host once per inner iteration"),
    (lambda p, cb, prob: p.step_control_type == StepControlType.Optimizing,
     "Optimizing: the interior point reads the host once per inner iteration"),
    (lambda p, cb, prob: p.linear_solver_type == LinearSolverType.MINRES,
     "MINRES: its iterations read the host every minres.CHECK_EVERY steps"),
    (lambda p, cb, prob: p.linear_solver_type == LinearSolverType.GMRES,
     "GMRES: its restarts are CUDA graphs of their own, read once per restart"),
)
"""The configurations that keep the eager loop on the card, each with the
host read that stops its iteration from being captured (the JAX package
runs display rows and callbacks through ``jax.debug.callback``, and its
inner loops as ``lax.while_loop``).  A problem that reads the host by
design declares it with a true ``evaluates_on_host`` attribute; any other
problem whose functions read the host makes the capture raise."""


def graph_route(params: Params, callbacks=None, problem=None):
    """Why the loop of this configuration runs eagerly on the card, or
    ``None`` when it runs as a CUDA graph there."""
    for applies, reason in EAGER_ON_CARD:
        if applies(params, callbacks, problem):
            return reason
    return None


def _diagnose(fns, x, y):
    """The problem function that cannot be captured as a CUDA graph at
    ``(x, y)``, a lane stack's first lane (one that reads the host), or
    None."""
    if x.ndim > 1:
        x, y = x[0], y[0]
    checks = [("objective", lambda x: fns.obj(x)), ("objective gradient", lambda x: fns.obj_grad(x))]
    if fns.num_cons > 0:
        checks += [("constraints", lambda x: fns.cons(x)), ("constraint Jacobian", lambda x: fns.cons_jac(x))]
    checks.append(("Lagrangian Hessian", lambda x: fns.lag_hess(x, y)))
    for name, evaluate in checks:
        try:
            capture(evaluate, (x,))
        except RuntimeError:
            return name
    return None


class ChunkLoop:
    """What the single and the lockstep solve loop share, for one (problem,
    params) pair on one device: the terminal tests (``check_terminate``),
    the step core (``step``), the route of a solve call (``decide_route``)
    and its chunk with the one host read (``run_chunk``, ``read``).  A
    subclass gives ``body`` (its order of tests and iteration), ``fns``,
    ``cfg``, ``controller`` and the penalty strategy.  Every helper acts on
    the last axis, so one code serves 0-dim and (B,) state alike."""

    def __init__(self, transform: Transformation, params: Params, device, callbacks=None):
        self.transform = transform
        self.params = params
        self.device = device
        self.callbacks = callbacks

        problem = transform.trans_problem
        self.n = problem.num_vars
        self.m = problem.num_cons
        self.lb = torch.as_tensor(problem.var_lb, dtype=params.dtype, device=device)
        self.ub = torch.as_tensor(problem.var_ub, dtype=params.dtype, device=device)

        if params.iteration_limit is not None:
            self.iteration_limit = int(params.iteration_limit)
        else:
            self.iteration_limit = int(params.iteration_limit_default)
        # whether a chunk may replay the body as a CUDA graph: on the card;
        # set false, the loop runs the eager route there (to compare them)
        self.use_graphs = device.type == "cuda"
        self.graphed = False  # the route of the current solve call (decide_route)
        self.graph = ChunkGraph(self.body, lambda s, fns=transform.fns: _diagnose(fns, s.it.x, s.it.y))

    def decide_route(self) -> bool:
        """Decide the route of a solve call at its start, from ``params``,
        the callbacks registered by then and the problem: the graph on the
        card unless the configuration is in ``EAGER_ON_CARD``.  Kept in
        ``graphed`` for the whole call."""
        reason = graph_route(self.params, self.callbacks, self.transform.orig_problem)
        self.graphed = self.use_graphs and reason is None
        return self.graphed

    def new_state(self, it, lead=(), eval_fail=(), path=()) -> LoopState:
        """The loop state at the start iterate ``it``, each scalar of shape
        ``lead``: () for one instance, (B,) for a lane stack."""
        params = self.params

        def full(value, dtype=params.dtype):
            return torch.full(lead, value, dtype=dtype, device=self.device)

        rho0, pstate0 = self.penalty_initial(*lead)
        zero = full(0, torch.int64)
        counters = Counters.zero(self.device, lead).add(**iterate_eval_counts(self.m))
        return LoopState(
            it=it,
            lamb=full(params.lamb_init),
            rho=full(rho0),
            error_sum=full(0.0),
            pstate=pstate0,
            iteration=zero,
            accepted_steps=zero,
            num_penalty_changes=zero,
            path_dist=full(0.0),
            status=full(RUNNING, torch.int64),
            counters=counters,
            eval_fail=eval_fail,
            rcond=full(float("nan")),
            path=path,
        )

    def check_terminate(self, state: LoopState):
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
        status = torch.full_like(state.status, RUNNING)
        status = torch.where(unbounded, int(SolverStatus.Unbounded), status)
        status = torch.where(infeas, int(SolverStatus.LocallyInfeasible), status)
        status = torch.where(optimal, int(SolverStatus.Optimal), status)
        return torch.where(
            state.iteration >= self.iteration_limit, int(SolverStatus.IterationLimit), status
        )

    def step(self, state: LoopState):
        """The step core of one outer iteration (reference
        ``solver.py:305-380``): the step, the penalty update with its veto,
        the counts, the path length, the lambda-limit status and rcond.
        Returns the new state, whose ``eval_fail`` and ``path`` are
        ``state``'s, with ``compute_step``'s output and the acceptance."""
        out = compute_step(
            self.cfg, self.controller, state.it, state.lamb, state.rho,
            state.error_sum, state.counters,
        )
        ctrl = out.ctrl
        next_it = ctrl.iterate

        # the penalty update runs on every candidate, applies only to
        # accepted steps and can veto them (reference solver.py:357-369)
        pres = self.penalty_update(state.it, next_it, state.rho, state.pstate)
        accept = ctrl.accepted & pres.accept
        rho_n = torch.where(accept, pres.rho, state.rho)
        step_norm = torch.linalg.vector_norm(next_it.x - state.it.x, dim=-1) + torch.linalg.vector_norm(
            next_it.y - state.it.y, dim=-1
        )
        # lambda blow-up (the reference raises, solver.py:323-326)
        status = torch.where(ctrl.lamb >= self.params.lamb_max, int(SolverStatus.LambdaLimit), RUNNING)
        rcond = ctrl.rcond if torch.is_tensor(ctrl.rcond) else torch.full_like(state.rcond, ctrl.rcond)
        state_n = state._replace(
            it=select(accept, next_it, state.it),
            lamb=ctrl.lamb,
            rho=rho_n,
            error_sum=ctrl.error_sum,
            pstate=select(ctrl.accepted, pres.state, state.pstate),
            iteration=state.iteration + 1,
            accepted_steps=state.accepted_steps + accept,
            num_penalty_changes=state.num_penalty_changes + (accept & (rho_n != state.rho)),
            path_dist=state.path_dist + torch.where(accept, step_norm, 0.0),
            status=status,
            counters=ctrl.counters,
            rcond=rcond,
        )
        return state_n, out, accept

    def run_iteration(self, state: LoopState) -> LoopState:
        """One outer iteration: the step core."""
        return self.step(state)[0]

    def eager_chunk(self, state: LoopState, k: int) -> LoopState:
        """Up to ``k`` bodies run eagerly while the status runs: on the CPU
        the status is in host memory, on the card each check is a host read
        (``HOST_READS["eager"]``)."""
        for _ in range(k):
            if state.status.device.type != "cpu":
                HOST_READS["eager"] += 1
            if not bool(torch.any(state.status == RUNNING)):
                break
            state = self.body(state)
        return state

    def run_chunk(self, state: LoopState, k: int, payload=None):
        """Up to ``k`` bodies from ``state`` on the route of the call
        (``graphed``): the CUDA graph's replays, stopped soon after the
        status is terminal (``graphs.ChunkGraph.run``), or ``eager_chunk``;
        no blocking read.  Then, in the same ``pgf.chunk`` span,
        ``payload(state)``: what the solve keeps and a vector for the host
        (None: no keep, the status), with the kernel launches that the
        chunk's bodies counted on the device appended on the graphed route.
        Returns ``(state, kept, pending)``; ``read(pending)`` reads it."""
        with span("pgf.chunk", width=state.status.numel(), bodies=k) as attrs:
            refined = _refined_solves() if attrs is not None else None
            if self.graphed:
                state = self.graph.run(state, k)
                if attrs is not None:  # the bodies replayed
                    attrs["bodies"] = self.graph.replayed
            else:
                state = self.eager_chunk(state, k)
            kept, vector = (None, state.status) if payload is None else payload(state)
            if self.graphed:
                vector = torch.cat([vector, device_launches(state.status.device).to(vector.dtype)])
        return state, kept, (vector, refined)

    def read(self, pending):
        """The chunk's one host read (``HOST_READS["chunk"]``) of
        ``run_chunk``'s vector, as numpy, in the ``pgf.wait`` span: on the
        graphed route the launch counts at its end go to
        ``util.add_device_launches``, and while a profiler records, the
        span's ``kkt_solves`` is the chunk's refined KKT solves."""
        vector, refined = pending
        HOST_READS["chunk"] += 1
        with span("pgf.wait") as attrs:
            values = vector.cpu().numpy()
            if self.graphed:
                n = len(values) - LAUNCH_SLOTS
                add_device_launches(vector.device, values[n:])
                values = values[:n]
            if attrs is not None and refined is not None:
                attrs["kkt_solves"] = _refined_solves() - refined
        return values

    def copy_out(self, tree):
        """``tree`` as tensors that a later solve does not overwrite: on the
        graphed route, copies of the graph's buffers."""
        return _clone_tree(tree) if self.graphed else tree


class SolveLoop(ChunkLoop):
    """The solve loop of one instance: ``ChunkLoop`` with the JAX body's
    order, the start, the ``eval_fail`` record, the path ring, the
    callbacks and the display rows."""

    def __init__(self, transform: Transformation, params: Params, device, callbacks=None):
        super().__init__(transform, params, device, callbacks)
        self.fns = transform.fns
        self.display = solver_display(self.m, params) if params.display else None
        self.cfg = make_control_cfg(self.fns, params, self.lb, self.ub)
        self.controller = make_controller(self.cfg)
        self.penalty_initial, self.penalty_update = penalty_strategy(params, self.m, self.fns, device)
        self._start_graph = None  # graphed_start's replay, captured at its first call

    def start(self, x, y) -> Start:
        """The start of a solve at ``(x, y)`` as pure tensor code, which
        ``graphed_start`` captures: the iterate of ``evaluate_iterate`` and,
        under ``params.validate_input``, ``validate_fns``'s verdicts made on
        the device (``START_FLAGS``) from the iterate's evaluations and the
        Lagrangian Hessian's.  The Jacobian is evaluated once more only in
        matrix-free mode, where the iterate holds none."""
        it = evaluate_iterate(self.fns, x, y)
        if not self.params.validate_input:
            return Start(it, None, True)
        n, m = self.n, self.m
        jac = self.fns.cons_jac(x) if self.fns.matrix_free else it.cons_jac
        hess = self.fns.lag_hess(x, y)
        shaped = (tuple(it.obj_grad.shape) == (n,) and tuple(it.cons.shape) == (m,)
                  and tuple(jac.shape) == (m, n) and tuple(hess.shape) == (n, n))
        flags = [torch.isfinite(t).all() for t in (it.obj, it.obj_grad, it.cons, jac, hess)]
        if tuple(hess.shape) == (n, n):
            flags.append(torch.isclose(hess, hess.T, rtol=1e-5, atol=1e-8).all())
        else:  # the eager check names the shape
            flags.append(torch.ones((), dtype=torch.bool, device=x.device))
        return Start(it, torch.stack(flags), shaped)

    def graphed_start(self, x, y) -> Start:
        """``start(x, y)`` replayed as a CUDA graph, captured at the first
        call (``graphs.cuda_graphed``: a warm-up run, then the capture, counted
        in ``util.CAPTURES``; a capture that fails raises
        ``GraphCaptureError`` naming the problem function that reads the
        host).  Returns the graph's output buffers, which the next call
        overwrites: a solve's first chunk copies them into its own."""
        if self._start_graph is None:
            t0 = time.perf_counter_ns()
            self._start_graph = cuda_graphed(self.start, (x, y), lambda: _diagnose(self.fns, x, y),
                                             "the solve's start")
            CAPTURES.update(graphs=1, ns=time.perf_counter_ns() - t0)
        STARTS["graphed"] += 1
        return self._start_graph(x, y)

    def init_state(self, x, y, it=None) -> LoopState:
        """The loop's state at the start ``(x, y)``, with the iterate ``it``
        when it was evaluated already (``graphed_start``)."""
        params = self.params
        path = ()
        if params.collect_path:
            cap = params.path_capacity
            buf = torch.zeros((cap, self.n + self.m), dtype=x.dtype, device=x.device)
            buf[0] = torch.cat([x, y])
            length = torch.ones((), dtype=torch.int64, device=x.device)
            path = (buf, torch.zeros(cap, dtype=x.dtype, device=x.device), length)
        eval_fail = ()
        if params.validate_input:
            zx, zy = torch.zeros_like(x), torch.zeros_like(y)
            eval_fail = (torch.zeros((), dtype=torch.bool, device=x.device), zx, zy, zx, zy)
        it = evaluate_iterate(self.fns, x, y) if it is None else it
        return self.new_state(it, eval_fail=eval_fail, path=path)

    def run_iteration(self, state: LoopState) -> LoopState:
        """One outer iteration: the step core (``ChunkLoop.step``), then the
        first non-finite candidate into ``eval_fail``, the accepted iterate
        into the path ring, the ``ComputedStep`` callback and the display
        row."""
        params = self.params
        state_n, out, accept = self.step(state)
        ctrl = out.ctrl
        next_it = ctrl.iterate

        eval_fail = state.eval_fail
        if eval_fail:
            flag, first_x, first_y, cand_x, cand_y = eval_fail
            # the first non-finite candidate (a broken factorization or a
            # failed evaluation; the diagnosis after the solve tells which)
            new_bad = ~out.eval_ok & ~flag
            eval_fail = (
                flag | ~out.eval_ok,
                torch.where(new_bad, out.first_x, first_x),
                torch.where(new_bad, out.first_y, first_y),
                torch.where(new_bad, out.cand_x, cand_x),
                torch.where(new_bad, out.cand_y, cand_y),
            )

        if self.callbacks is not None and not self.callbacks.empty(CallbackType.ComputedStep):
            self.callbacks(
                CallbackType.ComputedStep,
                (state.it.x, state.it.y),
                (next_it.x, next_it.y),
                bool(accept),
            )

        path = state.path
        if path:
            buf, times, length = path
            cap = params.path_capacity
            idx = torch.clamp(length, max=cap - 1).reshape(1)
            write = accept & (length < cap)
            row = torch.where(write, torch.cat([next_it.x, next_it.y]), buf.index_select(0, idx)[0])
            t_new = times.index_select(0, idx - 1)[0] + 1.0 / ctrl.lamb
            time_n = torch.where(write, t_new, times.index_select(0, idx)[0])
            path = (buf.index_copy(0, idx, row[None]), times.index_copy(0, idx, time_n.reshape(1)),
                    length + write)

        state_n = state_n._replace(eval_fail=eval_fail, path=path)
        if self.display is not None and self.display.should_display():
            self._emit_row(state, state_n, ctrl, accept)
        return state_n

    def _emit_row(self, state: LoopState, state_n: LoopState, ctrl, accept) -> None:
        """One display row (reference ``solver.py:288-343``): the values of
        the iterate the step started from, the step to the candidate, and
        the new lambda and rho; one host read."""
        params = self.params
        it, cand = state.it, ctrl.iterate
        names = ["aug_lag", "obj", "cons_viol", "stat_res", "active", "obj_nonlin", "|dx|", "|dy|",
                 "iter", "lamb", "rho", "accept"]
        values = [
            aug_lag(it, state.rho),
            it.obj,
            cons_violation(it),
            stat_res(it, self.lb, self.ub, params.active_tol, self.fns),
            ctrl.active_set.sum(),
            obj_nonlin(it, cand),
            torch.linalg.vector_norm(cand.x - it.x),
            torch.linalg.vector_norm(cand.y - it.y),
            state.iteration + 1,
            state_n.lamb,
            state_n.rho,
            accept,
        ]
        if params.report_rcond:
            names.append("rcond")
            values.append(ctrl.rcond)
        values = [torch.as_tensor(v, dtype=torch.float64, device=it.x.device) for v in values]
        row = dict(zip(names, torch.stack(values).tolist()))
        row.update(iter=int(row["iter"]), active=int(row["active"]), accept=bool(row["accept"]))
        self.display.row(row)

    def _tested(self, state: LoopState) -> LoopState:
        """``state`` with the terminal tests' status, unless it already has
        a terminal one."""
        status = torch.where(state.status == RUNNING, self.check_terminate(state), state.status)
        return state._replace(status=status)

    def body(self, state: LoopState) -> LoopState:
        """One pass of the JAX package's ``lax.while_loop`` body: the
        terminal tests, then one iteration unless they end the solve; a
        state that is already terminal comes back unchanged, bit for bit.
        No host read: the iteration is computed either way and a
        ``torch.where`` keeps the state that applies."""
        tested = self._tested(state)
        return select(tested.status == RUNNING, self.run_iteration(tested), tested)

    def eager_chunk(self, state: LoopState, k: int) -> LoopState:
        """Up to ``k`` bodies run eagerly: the terminal tests, then the
        iteration only when they leave the solve running (so a host
        callback or display row sees each iteration once).  On the CPU the
        status is in host memory; on the card each test is a host read
        (``HOST_READS["eager"]``).  The states are ``body``'s, bit for bit."""
        for _ in range(k):
            state = self._tested(state)
            if state.status.device.type != "cpu":
                HOST_READS["eager"] += 1
            if int(state.status) != RUNNING:
                break
            state = self.run_iteration(state)
        return state

    def _finalize(self, state: LoopState, x0, y0):
        """What the solve returns, fused into the chunk's one read
        (``pygradflow_tpu/solver.py:361-411``): the solution triple as
        tensors and the result's scalars packed into one f64 vector whose
        last entry is the status."""
        params = self.params
        it = state.it
        d = bounds_dual(it, self.lb, self.ub, params.active_tol, self.fns)
        direct_dist = torch.sqrt(torch.sum((it.x - x0) ** 2) + torch.sum((it.y - y0) ** 2))
        eval_flag = state.eval_fail[0] if state.eval_fail else torch.zeros((), dtype=torch.bool, device=self.device)
        path_len = state.path[2] if state.path else state.iteration
        values = (
            direct_dist,
            stat_res(it, self.lb, self.ub, params.active_tol, self.fns),
            cons_violation(it),
            it.obj,
            state.rho,
            state.path_dist,
            state.lamb,
            state.iteration,
            state.accepted_steps,
            state.num_penalty_changes,
            *state.counters,
            state.rcond,
            eval_flag,
            path_len,
            state.status,
        )
        scalars = torch.stack([v.to(torch.float64) for v in values])
        return self.transform.restore_sol(it.x, it.y, d), scalars

    def run_chunks(self, x, y, timer: Timer, state=None, ckpt=None):
        """Drive a solve from ``(x, y)``, or from ``state`` (a resumed
        snapshot), in chunks of ``params.jit_chunk`` bodies (``run_chunk``)
        with one host read per chunk: the packed scalars of ``_finalize``,
        the status last.  At each chunk boundary ``ckpt`` may write a
        snapshot and the time limit is checked.  Returns ``(state, sol,
        scalars)``: the final state and the solution triple, the graph's
        buffers on the graphed route (``copy_out``), and the scalars as a
        list of floats."""
        if state is None:
            state = self.init_state(x, y)
        while True:
            state, sol, pending = self.run_chunk(state, self.params.jit_chunk, lambda s: self._finalize(s, x, y))
            scalars = self.read(pending).tolist()
            if int(scalars[-1]) != RUNNING:
                break
            if ckpt is not None:
                ckpt.maybe_save(state)
            if timer.reached_time_limit():
                scalars[-1] = int(SolverStatus.TimeLimit)
                state = state._replace(status=torch.full_like(state.status, int(SolverStatus.TimeLimit)))
                break
        return state, sol, scalars


def _refined_solves() -> int:
    """``ldlt_kernels.REFINED["solves"]``, read only while a profiler
    records spans.  The kernels' module is imported here and not with this
    one: a solve on another tier leaves it unloaded, and it registers its
    launch counts when first imported (``util.register_launches``)."""
    from .linalg.ldlt_kernels import REFINED

    return REFINED["solves"]


def _clone_tree(value):
    if torch.is_tensor(value):
        return value.clone()
    if isinstance(value, tuple):
        return type(value)(*map(_clone_tree, value)) if hasattr(value, "_fields") else tuple(map(_clone_tree, value))
    return value


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


def resolve_device(device) -> torch.device:
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
        self.device = resolve_device(device)
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
        if self.params.profile_dir:
            return _profiled(lambda: self._solve(x0, y0, checkpoint_path, resume), self.params.profile_dir,
                             self.device)
        return self._solve(x0, y0, checkpoint_path, resume)

    def _solve(self, x0, y0, checkpoint_path, resume) -> SolverResult:
        params = self.params
        loop = self._loop
        begin_call()

        with span("pgf.prepare"):
            loop.decide_route()
            x, y = self.transform.create_transformed_initial(x0, y0, self.device)

            it = self._start(x, y)

            print_problem_stats(self.problem, loop.n, loop.m)

            deriv_check_problem(self.problem, params, x, y)

            timer = Timer(params.time_limit)

            ckpt = None
            state0 = loop.init_state(x, y, it)
            if checkpoint_path is not None:
                from .checkpoint import CheckpointManager

                ckpt = CheckpointManager(checkpoint_path)
                if resume and ckpt.exists():
                    state0 = ckpt.restore(state0)

        state, sol, scalars = loop.run_chunks(x, y, timer, state=state0, ckpt=ckpt)
        with span("pgf.finish"):
            state, sol = loop.copy_out((state, sol))
            return self._result(state, sol, scalars, timer)

    def _start(self, x, y):
        """The input check under ``params.validate_input``, and the start
        iterate where it comes with it (else None: ``init_state`` evaluates
        it).  On the graphed route one replay of the loop's start graph
        gives both, and the check's verdicts come in one host read
        (``HOST_READS["start"]``): a false finiteness verdict, or shapes
        that are not the problem's, run ``validate_fns`` at the same point
        to raise the error it names, and a false symmetry verdict logs its
        warning.  Elsewhere ``validate_fns`` runs eagerly."""
        loop, validate = self._loop, self.params.validate_input
        with span("pgf.check_input", graphed=loop.graphed) if validate else contextlib.nullcontext():
            if not loop.graphed:
                STARTS["eager"] += 1
                if validate:
                    self._validate(x, y)
                return None
            start = loop.graphed_start(x, y)
            if validate:
                HOST_READS["start"] += 1
                *finite, symmetric = start.flags.tolist()
                if not (start.shaped and all(finite)):
                    STARTS["fallback"] += 1
                    self._validate(x, y)
                elif not symmetric:
                    logger.warning("Hessian not numerically symmetric")
            return start.it

    def _validate(self, x, y) -> None:
        try:
            validate_fns(self.transform.fns, x, y)
        except EvalError as e:
            raise Exception("Failed to evaluate initial iterate") from e

    def _result(self, state, sol, scalars, timer) -> SolverResult:
        """The ``SolverResult`` of a solve that ended in ``state`` with the
        solution triple ``sol`` and the scalars of its last read."""
        params = self.params
        x_r, y_r, d_r = sol
        total_time = timer.elapsed()
        (direct_dist, final_stat_res, final_cons_violation, final_obj, rho, path_dist, lamb,
         iterations, accepted_steps, penalty_changes, *counts) = scalars[:15]
        final_rcond, eval_flag, path_len, status = scalars[15:]
        status = SolverStatus(int(status))
        iterations, accepted_steps, penalty_changes = int(iterations), int(accepted_steps), int(penalty_changes)

        failed_component, fail_x = None, None
        if eval_flag:
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
                f"Inverse step size {lamb} exceeded maximum "
                f"{params.lamb_max} (incorrect derivatives?)"
            )

        dist_factor = path_dist / direct_dist if direct_dist != 0.0 else 1.0
        num_evals = Counters(*(int(c) for c in counts)).as_dict()

        self._print_result(
            total_time=total_time,
            status=status,
            iterations=iterations,
            accepted_steps=accepted_steps,
            penalty_changes=penalty_changes,
            rho=rho,
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
            iterations=iterations,
            num_accepted_steps=accepted_steps,
            total_time=total_time,
            dist_factor=dist_factor,
            final_scaled_obj=final_obj,
            final_stat_res=final_stat_res,
            final_cons_violation=final_cons_violation,
            num_penalty_changes=penalty_changes,
            num_evals=num_evals,
            final_rcond=final_rcond,
        )
        if params.collect_path:
            buf, times, _ = state.path
            length = int(path_len)
            # the initial point and one column per accepted step, unless the
            # ring stopped at its capacity (the reference path is unbounded)
            if accepted_steps + 1 > length:
                logger.warning(
                    "Trajectory truncated: %d accepted steps exceed path_capacity=%d; "
                    "raise Params.path_capacity to record the full path",
                    accepted_steps,
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
