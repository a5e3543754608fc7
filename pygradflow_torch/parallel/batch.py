"""Batched instance sweeps: many instances of one problem structure solved
in lockstep (counterpart of ``pygradflow_tpu/parallel/batch.py``).

The JAX package vmaps its whole solve loop.  ``torch.func.vmap`` cannot
batch a Python branch on a tensor, a host read or the ctypes launch of a
kernel, so here the loop carries one explicit lane axis instead: the state
is (B, ...) tensors with (B,) status, lambda, rho and counters, and every
decision is a per-lane ``torch.where``.  ``torch.func.vmap`` serves only the
problem's derivatives (``eval.lane_fns``).  Lanes are independent: a lane's
trajectory does not depend on the others or on the batch width.

One lockstep iteration (``LaneLoop.body``) reads nothing on the host: Exact
step control and Globalized Newton run their inner loops to the limit.  A
chunk runs up to ``params.jit_chunk`` bodies and the host reads the status
vector once per chunk (``LaneLoop.read``, ``util.HOST_READS["chunk"]``), as
the JAX package's ``_run_chunk`` does.  On the card the body is a CUDA
graph (``util.ChunkGraph``), captured at the first use of each width and
replayed up to ``jit_chunk`` times per chunk, stopped soon after every lane
is terminal (a lane whose status is terminal passes through a replay
unchanged); on the CPU, or for a configuration in
``solver.EAGER_ON_CARD``, the same body runs eagerly, checking before each
iteration whether a lane still runs (on the card one host read each,
``HOST_READS["eager"]``).  The inner loops of BoxReduced and Optimizing
(the box solver's iterations, the interior point's), MINRES's iterations
and GMRES's restarts end when no lane still runs, read on the host once
per iteration (MINRES: every ``minres.CHECK_EVERY``), where the JAX
package's vmapped ``lax.while_loop`` decides on the device; these keep the
eager loop.  A lane that has left such a loop keeps its values bit for
bit.  A lane whose status is terminal is frozen: it keeps computing in
lockstep, and its result is discarded.  ``compact`` harvests terminated
lanes at chunk boundaries and re-packs the running remainder into
power-of-four width tiers (``_solve_compacting``), so stragglers run at
straggler width; each tier has a graph of its own.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from ..eval import Counters, lane_fns
from ..iterate import (
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
from ..params import Params
from ..penalty import penalty_strategy
from ..problem import Problem
from ..solver import _clone_tree, _diagnose, _resolve_device, graph_route
from ..status import RUNNING, SolverStatus
from ..step.control import compute_step, make_control_cfg, make_controller
from ..timer import Timer
from ..transform import Transformation
from ..util import HOST_READS, ChunkGraph, add_device_launches, begin_call, device_launches, select, span, tree_map


class ParametricProblem(Problem):
    """Problem with per-instance data.

    Subclasses implement ``p_obj(x, data)`` (and ``p_cons(x, data)`` when
    there are constraints) instead of ``obj``/``cons``, as pure tensor code;
    ``data`` is a tuple of tensors.  :class:`BatchedSolver` sweeps a batch
    of data tuples, each tensor with a leading lane dimension, and hands
    each lane its slice as an argument.  ``example_data`` is what a single
    ``Solver`` evaluates with.
    """

    def __init__(self, var_lb, var_ub, example_data, **args):
        self.example_data = example_data
        super().__init__(var_lb, var_ub, **args)

    def p_obj(self, x, data):
        raise NotImplementedError()

    def p_cons(self, x, data):
        raise NotImplementedError()

    def obj(self, x, data=None):
        return self.p_obj(x, self.example_data if data is None else data)

    def cons(self, x, data=None):
        return self.p_cons(x, self.example_data if data is None else data)


class BatchResult(NamedTuple):
    """Structure-of-arrays result of a batched solve (leading dim = batch),
    tensors on the solver's device."""

    x: Any
    y: Any
    d: Any
    status: Any  # int64 (B,), SolverStatus values
    iterations: Any
    accepted_steps: Any
    total_res: Any
    cons_violation: Any
    stat_res: Any
    counters: Counters  # (B,) evaluation counts per component
    rcond: Any = None  # (B,) estimate of each lane's last step; None when off

    @property
    def success(self):
        return self.status == int(SolverStatus.Optimal)


class LaneState(NamedTuple):
    it: Iterate
    lamb: Any
    rho: Any
    error_sum: Any
    pstate: Any
    iteration: Any
    accepted_steps: Any
    num_penalty_changes: Any
    path_dist: Any
    status: Any
    counters: Counters
    rcond: Any


class LaneLoop:
    """The solve loop over a lane stack, for one (problem, params) pair.
    The decisions are those of ``solver.SolveLoop``, taken per lane."""

    def __init__(self, transform: Transformation, params: Params, device):
        self.transform = transform
        self.params = params
        problem = transform.trans_problem
        self.m = problem.num_cons
        self.device = device
        self.lb = torch.as_tensor(problem.var_lb, dtype=params.dtype, device=device)
        self.ub = torch.as_tensor(problem.var_ub, dtype=params.dtype, device=device)
        if params.iteration_limit is not None:
            self.iteration_limit = int(params.iteration_limit)
        else:
            self.iteration_limit = int(params.iteration_limit_default)
        self._bound = {}
        self.bind(None)
        self.graph = ChunkGraph(self.body, lambda s, fns=transform.fns: _diagnose(fns, s.it.x[0], s.it.y[0]))

    def bind(self, data):
        """Point the lane closures at the data of the lanes now in the stack
        (``None`` for a plain problem).  The closures of each width read a
        buffer of their own, which ``data`` is copied into, so that a CUDA
        graph captured on them sees the data of every later bind."""
        key = None if data is None else tuple((tuple(a.shape), a.dtype) for a in data)
        bound = self._bound.get(key)
        if bound is None:
            buf = None if data is None else tuple(a.clone() for a in data)
            fns = lane_fns(self.transform.fns, buf)
            cfg = make_control_cfg(fns, self.params, self.lb, self.ub)
            penalty = penalty_strategy(self.params, self.m, fns, self.device)
            bound = self._bound[key] = (buf, fns, cfg, make_controller(cfg), penalty)
        elif data is not None:
            for dst, src in zip(bound[0], data):
                if dst is not src:
                    dst.copy_(src)
        _, self.fns, self.cfg, self.controller, (self.penalty_initial, self.penalty_update) = bound

    def init_state(self, x, y) -> LaneState:
        params = self.params
        batch = x.shape[0]

        def full(value, dtype=params.dtype):
            return torch.full((batch,), value, dtype=dtype, device=x.device)

        rho0, pstate0 = self.penalty_initial(batch)
        zero = full(0, torch.int64)
        counters = Counters.zero_lanes(batch, x.device).add(**iterate_eval_counts(self.m))
        state = LaneState(
            it=evaluate_iterate(self.fns, x, y),
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
            rcond=full(float("nan")),
        )
        return state._replace(status=self.check_terminate(state))

    def check_terminate(self, state: LaneState):
        """Per-lane termination in the reference's priority: a later test
        overrides an earlier one (``SolveLoop.check_terminate``)."""
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

    def run_iteration(self, state: LaneState) -> LaneState:
        """One outer iteration on every lane (``SolveLoop.run_iteration``)."""
        ctrl = compute_step(
            self.cfg, self.controller, state.it, state.lamb, state.rho,
            state.error_sum, state.counters,
        ).ctrl
        next_it = ctrl.iterate
        step_norm = torch.linalg.vector_norm(next_it.x - state.it.x, dim=-1) + torch.linalg.vector_norm(
            next_it.y - state.it.y, dim=-1
        )
        # the penalty update runs on every candidate, applies only to
        # accepted steps and can veto them (reference solver.py:357-369)
        pres = self.penalty_update(state.it, next_it, state.rho, state.pstate)
        accept = ctrl.accepted & pres.accept
        rho_n = torch.where(accept, pres.rho, state.rho)
        lambda_limit = ctrl.lamb >= self.params.lamb_max
        rcond = ctrl.rcond if torch.is_tensor(ctrl.rcond) else torch.full_like(state.rcond, ctrl.rcond)
        return LaneState(
            it=select(accept, next_it, state.it),
            lamb=ctrl.lamb,
            rho=rho_n,
            error_sum=ctrl.error_sum,
            pstate=select(ctrl.accepted, pres.state, state.pstate),
            iteration=state.iteration + 1,
            accepted_steps=state.accepted_steps + accept,
            num_penalty_changes=state.num_penalty_changes + (accept & (rho_n != state.rho)),
            path_dist=state.path_dist + torch.where(accept, step_norm, 0.0),
            status=torch.where(lambda_limit, int(SolverStatus.LambdaLimit), RUNNING),
            counters=ctrl.counters,
            rcond=rcond,
        )

    def body(self, state: LaneState) -> LaneState:
        """One iteration on every lane, then the terminal tests on the new
        state; lanes that were terminal keep theirs.  The single loop tests
        at the start of the next iteration, which decides the same."""
        new = self.run_iteration(state)
        status = torch.where(new.status == RUNNING, self.check_terminate(new), new.status)
        return select(state.status == RUNNING, new._replace(status=status), state)

    def eager_chunk(self, state: LaneState, k: int) -> LaneState:
        """Up to ``k`` bodies run eagerly while a lane runs: on the CPU the
        status is in host memory, on the card each check is a host read
        (``HOST_READS["eager"]``)."""
        for _ in range(k):
            if state.status.device.type != "cpu":
                HOST_READS["eager"] += 1
            if not bool(torch.any(state.status == RUNNING)):
                break
            state = self.body(state)
        return state

    def graphed_chunk(self, state: LaneState, k: int) -> LaneState:
        """Up to ``k`` bodies replayed as the CUDA graph of this width,
        stopped soon after every lane is terminal (``util.ChunkGraph.run``),
        a terminal lane unchanged by them; no blocking read of the state."""
        return self.graph.run(state, k)

    def chunk_route(self):
        """The chunk runner, decided from ``params`` before the solve: the
        graph on the card unless the configuration is in
        ``solver.EAGER_ON_CARD``."""
        if self.device.type == "cuda" and graph_route(self.params, problem=self.transform.orig_problem) is None:
            return self.graphed_chunk
        return self.eager_chunk

    def run_chunk(self, state: LaneState, chunk: int) -> LaneState:
        """At most ``chunk`` iterations while a lane runs, through the
        route of ``chunk_route``; no blocking read.  The span's ``bodies``
        is, on the graphed route, the bodies replayed."""
        route = self.chunk_route()
        with span("pgf.chunk", width=state.status.shape[0], bodies=chunk) as attrs:
            state = route(state, chunk)
            if attrs is not None and route == self.graphed_chunk:
                attrs["bodies"] = self.graph.replayed
            return state

    def read(self, state: LaneState):
        """The status vector on the host (numpy): the one host read per
        chunk.  On the graphed route it carries the kernel launches that the
        chunk's bodies counted on the device (``util.add_device_launches``)."""
        HOST_READS["chunk"] += 1
        if self.chunk_route() != self.graphed_chunk:
            with span("pgf.wait"):
                return state.status.cpu().numpy()
        device = state.status.device
        launches = device_launches(device)
        packed = torch.cat([state.status, launches])
        with span("pgf.wait"):
            packed = packed.cpu().numpy()
        lanes = state.status.numel()
        add_device_launches(device, packed[lanes:])
        return packed[:lanes]

    def finalize(self, state: LaneState):
        params = self.params
        state = _clone_tree(state)  # a graph's buffers: the next solve overwrites them
        it = state.it
        d = bounds_dual(it, self.lb, self.ub, params.active_tol, self.fns)
        x, y, d = self.transform.restore_sol(it.x, it.y, d)
        return BatchResult(
            x=x,
            y=y,
            d=d,
            status=state.status,
            iterations=state.iteration,
            accepted_steps=state.accepted_steps,
            total_res=total_res(it, self.lb, self.ub, params.active_tol, self.fns),
            cons_violation=cons_violation(it),
            stat_res=stat_res(it, self.lb, self.ub, params.active_tol, self.fns),
            counters=state.counters,
            rcond=state.rcond if params.report_rcond else None,
        )


def _time_out(state: LaneState) -> LaneState:
    status = torch.where(state.status == RUNNING, int(SolverStatus.TimeLimit), state.status)
    return state._replace(status=status)


class BatchedSolver:
    """Solves a batch of instances of one problem structure in lockstep.

    ``problem`` may be a plain :class:`Problem` (batch over initial points
    only) or a :class:`ParametricProblem` (also batch over data).  All
    tensors of a solve live on ``device``: without one, the current CUDA
    device, and the constructor raises ``RuntimeError`` when there is no
    card (CPU use passes ``device="cpu"``).
    """

    def __init__(
        self,
        problem: Problem,
        params: Optional[Params] = None,
        compact: Optional[bool] = None,
        harvest_chunk: Optional[int] = None,
        min_tier: int = 64,
        device=None,
    ):
        """``compact``: harvest terminated lanes at chunk boundaries and
        shrink the running batch to power-of-four width tiers (None = auto:
        on when the batch is at least ``4 * min_tier`` wide).
        ``harvest_chunk`` sets the iterations between shrink checks (None =
        ``params.jit_chunk``); ``min_tier`` is the smallest width tiers
        shrink to."""
        if params is None:
            params = Params()
        if params.display:
            raise ValueError("display is not supported in batched mode")
        if params.collect_path:
            raise ValueError("collect_path is not supported in batched mode")
        self.orig_problem = problem
        self.params = params
        self.device = _resolve_device(device)
        self.transform = Transformation(problem, params, self.device)
        self.loop = LaneLoop(self.transform, params, self.device)
        self.parametric = isinstance(problem, ParametricProblem)
        self.compact = compact
        self.harvest_chunk = None if harvest_chunk is None else int(harvest_chunk)
        self.min_tier = int(min_tier)

    def _initial(self, x0, y0, data):
        """Lane initial points on the device, scaled, with slacks appended."""
        params = self.params
        x0 = torch.as_tensor(x0, dtype=params.dtype, device=self.device)
        batch = x0.shape[0]
        if y0 is None:
            y0 = torch.zeros((batch, self.orig_problem.num_cons), dtype=params.dtype, device=self.device)
        else:
            y0 = torch.as_tensor(y0, dtype=params.dtype, device=self.device)
        args = () if data is None else (data,)
        return vmap(self.transform.transform_sol)(x0, y0, *args)

    def _data(self, data):
        if not self.parametric:
            return None
        if data is None:
            raise ValueError("a ParametricProblem needs batched data")

        def leaf(a):
            a = torch.as_tensor(a, device=self.device)
            return a.to(self.params.dtype) if a.is_floating_point() else a

        return tuple(leaf(a) for a in data)

    def solve(self, x0, y0=None, data=None) -> BatchResult:
        """Solve the batch.  ``x0``: (B, n_orig); ``y0``: (B, m_orig) or
        None; ``data``: a tuple of (B, ...) arrays for a parametric
        problem."""
        params = self.params
        loop = self.loop
        begin_call()
        with span("pgf.prepare"):
            data = self._data(data)
            x, y = self._initial(x0, y0, data)
            if self.parametric:
                loop.bind(data)
            state = loop.init_state(x, y)

        timer = Timer(params.time_limit)
        compact = self.compact
        if compact is None:
            compact = x.shape[0] >= 4 * self.min_tier
        if compact:
            state = self._solve_compacting(state, data, timer)
        else:
            while True:
                state = loop.run_chunk(state, params.jit_chunk)
                if not (loop.read(state) == RUNNING).any():
                    break
                if timer.reached_time_limit():
                    state = _time_out(state)
                    break
        with span("pgf.finish"):
            if compact and self.parametric:  # finalize reads every lane's data again
                loop.bind(data)
            return loop.finalize(state)

    def _solve_compacting(self, state: LaneState, data, timer) -> LaneState:
        """Chunked solve with lane harvesting and width compaction
        (reference ``batch.py:263-347``).

        Invariants: ``state`` has width W; its first L lanes are the
        running instances, the rest pads (copies of done lanes, frozen by
        their terminal status).  ``orig_idx`` maps each lane to its row of
        the batch, with B (out of range) for pads.  ``archive`` is the full
        batch; lanes are scattered back into it when the running set
        shrinks to a smaller tier, and once at the end."""
        params = self.params
        loop = self.loop
        chunk = params.jit_chunk if self.harvest_chunk is None else min(params.jit_chunk, self.harvest_chunk)
        batch = state.status.shape[0]
        archive = state
        orig_idx = torch.arange(batch, device=self.device)
        active = np.arange(batch)
        shrunk = False
        timed_out = False

        def scatter(archive, state, orig_idx):
            keep = orig_idx < batch
            rows = orig_idx[keep]

            def put(a, s):
                a = a.clone()
                a[rows] = s[keep]
                return a

            return tree_map(put, archive, state)

        while True:
            state = loop.run_chunk(state, chunk)
            running = loop.read(state)[: active.size] == RUNNING
            timed_out = timer.reached_time_limit()
            if timed_out or not running.any():
                break
            # shrink only when the running set fits a smaller power-of-four
            # tier: a tight iteration distribution pays nothing
            keep = np.where(running)[0]
            width = state.status.shape[0]
            new_width = width
            while new_width // 4 >= max(keep.size, self.min_tier):
                new_width //= 4
            if new_width == width:
                continue
            with span("pgf.compact", width=width, new_width=new_width):
                archive = scatter(archive, state, orig_idx)
                done_rows = np.where(~running)[0]
                pad_rows = np.resize(done_rows, new_width - keep.size)
                gather = torch.as_tensor(np.concatenate([keep, pad_rows]), device=self.device)
                state = tree_map(lambda a: a[gather], state)
                if data is not None:
                    data = tuple(a[gather] for a in data)
                    loop.bind(data)
                orig_idx = orig_idx[gather]
                orig_idx[keep.size :] = batch
                active = active[keep]
            shrunk = True

        if shrunk:
            with span("pgf.compact", width=state.status.shape[0], new_width=batch):
                state = scatter(archive, state, orig_idx)
        return _time_out(state) if timed_out else state
