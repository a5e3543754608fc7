"""Batched instance sweeps: many instances of one problem structure solved
in lockstep (counterpart of ``pygradflow_tpu/parallel/batch.py``).

The JAX package vmaps its whole solve loop.  ``torch.func.vmap`` cannot
batch a Python branch on a tensor, a host read or the ctypes launch of a
kernel, so here the loop carries one explicit lane axis instead: the state
is (B, ...) tensors with (B,) status, lambda, rho and counters, and every
decision is a per-lane ``torch.where``.  ``torch.func.vmap`` serves only the
problem's derivatives (``eval.lane_fns``).  Lanes are independent: a lane's
trajectory does not depend on the others or on the batch width.

``LaneLoop`` is ``solver.ChunkLoop`` over a lane stack: its terminal
tests, step core, route and chunk with the one host read are the single
loop's, on a ``solver.LoopState`` whose tensors carry the lane axis (no
``eval_fail`` record, no path).  It adds the lockstep body (the iteration,
then the terminal tests), the per-width closures over the lanes' data
(``bind``) and the finalizer.  One lockstep iteration reads nothing on the
host: Exact step control and Globalized Newton run their inner loops to
the limit.  A chunk runs up to ``params.jit_chunk`` bodies and the host
reads the status vector once per chunk (``LaneLoop.read``,
``util.HOST_READS["chunk"]``), as the JAX package's ``_run_chunk`` does.
On the card the body is a CUDA graph (``graphs.ChunkGraph``), captured at
the first use of each width and replayed up to ``jit_chunk`` times per
chunk, stopped soon after every lane is terminal (a lane whose status is
terminal passes through a replay unchanged); on the CPU, or for a
configuration in ``solver.EAGER_ON_CARD``, the same body runs eagerly,
checking before each iteration whether a lane still runs (on the card one
host read each, ``HOST_READS["eager"]``).  The inner loops of BoxReduced
and Optimizing (the box solver's iterations, the interior point's),
MINRES's iterations and GMRES's restarts end when no lane still runs, read
on the host once per iteration (MINRES: every ``minres.CHECK_EVERY``),
where the JAX package's vmapped ``lax.while_loop`` decides on the device;
these keep the eager loop.  A lane that has left such a loop keeps its
values bit for bit.  A lane whose status is terminal is frozen: it keeps
computing in lockstep, and its result is discarded.  ``compact`` harvests
terminated lanes at chunk boundaries and re-packs the running remainder
into power-of-four width tiers (``_solve_compacting``), so stragglers run
at straggler width; each tier has a graph of its own.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from ..eval import Counters, lane_fns
from ..iterate import (
    bounds_dual,
    cons_violation,
    evaluate_iterate,
    stat_res,
    total_res,
)
from ..params import Params
from ..penalty import penalty_strategy
from ..problem import Problem
from ..solver import ChunkLoop, LoopState, resolve_device
from ..status import RUNNING, SolverStatus
from ..step.control import make_control_cfg, make_controller
from ..timer import Timer
from ..transform import Transformation
from ..util import begin_call, select, span, tree_map


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


class LaneLoop(ChunkLoop):
    """The solve loop over a lane stack, for one (problem, params) pair:
    ``solver.ChunkLoop``'s decisions, taken per lane, on a ``LoopState``
    whose tensors carry a lane axis, with no ``eval_fail`` and no path."""

    def __init__(self, transform: Transformation, params: Params, device):
        super().__init__(transform, params, device)
        self._bound = {}
        self.bind(None)

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

    def init_state(self, x, y) -> LoopState:
        state = self.new_state(evaluate_iterate(self.fns, x, y), (x.shape[0],))
        return state._replace(status=self.check_terminate(state))

    def body(self, state: LoopState) -> LoopState:
        """One iteration on every lane, then the terminal tests on the new
        state; lanes that were terminal keep theirs.  The single loop tests
        at the start of the next iteration, which decides the same."""
        new = self.run_iteration(state)
        status = torch.where(new.status == RUNNING, self.check_terminate(new), new.status)
        return select(state.status == RUNNING, new._replace(status=status), state)

    def finalize(self, state: LoopState):
        params = self.params
        state = self.copy_out(state)
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


def time_out(state: LoopState) -> LoopState:
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
        self.device = resolve_device(device)
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
            loop.decide_route()
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
                state, _, pending = loop.run_chunk(state, params.jit_chunk)
                if not (loop.read(pending) == RUNNING).any():
                    break
                if timer.reached_time_limit():
                    state = time_out(state)
                    break
        with span("pgf.finish"):
            if compact and self.parametric:  # finalize reads every lane's data again
                loop.bind(data)
            return loop.finalize(state)

    def _solve_compacting(self, state: LoopState, data, timer) -> LoopState:
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
            state, _, pending = loop.run_chunk(state, chunk)
            running = loop.read(pending)[: active.size] == RUNNING
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
        return time_out(state) if timed_out else state
