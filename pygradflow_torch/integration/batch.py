"""Batched continuous-flow solves on the flat chunked engine (counterpart
of ``pygradflow_tpu/integration/batch.py``).

A whole batch of continuous-homotopy solves of one problem runs as one
lane stack through ``flat_loop.py``: one uniform work unit per lane per
iteration, so lanes progress independently, in chunks of
``params.integration_chunk`` units.

- ``params.time_limit`` is enforced between chunks;
- finished lanes are harvested at chunk boundaries and the running
  remainder is compacted to the next power-of-two tier of at least 8 lanes,
  padded with frozen copies of lane 0;
- on a CUDA device a chunk replays CUDA graphs of one work unit, captured
  once per tier (``FlatRunner``), with one host read per unit.  Inside a
  graph every loop runs a fixed trip count, masked per lane: the fast graph
  cuts each Newton solve at ``integrator.FAST_NEWTON_TRIPS`` iterations
  without the stage escalation, and the full graph, replayed on the same
  inputs only for the units where a lane needs more, runs everything to
  the full count.  The graphs give the same bits as the eager units.  A
  failed capture fails the solve.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from ..eval import lane_fns
from ..iterate import bounds_dual, evaluate_iterate
from ..params import Params
from ..status import RUNNING, SolverStatus
from ..timer import Timer
from ..util import any_running
from . import flow as fl
from .flat_loop import make_flat_loop
from .integration_solver import IntegrationSolver
from .integrator import graph_pair

_HARVEST_KEYS = ("z", "status", "iteration", "rho", "steps", "newtons", "units")
_MIN_TIER = 8


class FlatRunner:
    """The flat engine's chunks for one (problem, params): eager on the
    CPU; on a CUDA device one graph pair (``integrator.graph_pair``) of one
    work unit, replayed with one host read per unit."""

    def __init__(self, cfg, fns, lb, ub, params, every):
        self.init, self._chunk, self.collect = make_flat_loop(cfg, fns, lb, ub, params)
        self.budget = int(params.integration_chunk)
        self.every = every
        self._keys = None

        def unit(*tensors, every, escalate):
            state = dict(zip(self._keys, tensors))
            out = self._chunk(state, 1, every, escalate)
            return tuple(out[k] for k in self._keys), state["status"] == RUNNING

        self._pair = graph_pair(unit, "newton")

    def chunk(self, state):
        """One chunk: ``params.integration_chunk`` work units while a lane
        runs."""
        if not state["z"].is_cuda:
            return self._chunk(state, self.budget, self.every)
        self._keys = keys = tuple(state)
        for _ in range(self.budget):
            if not any_running(state["status"] == RUNNING, "flat"):
                break
            state = dict(zip(keys, self._pair(*(state[k] for k in keys))[: len(keys)]))
        # the replay's outputs are the graph's own buffers: detach them
        return {k: v.clone() for k, v in state.items()}

    def run(self, state, timer):
        """Chunks until no lane runs or the time limit is reached."""
        while True:
            state = self.chunk(state)
            running = state["status"] == RUNNING
            if not any_running(running, "flat"):
                return state
            if timer.reached_time_limit():
                status = torch.where(running, int(SolverStatus.TimeLimit), state["status"])
                return dict(state, status=status)


class BatchedIntegrationResult(NamedTuple):
    """Structure-of-arrays result (leading dim = batch), tensors on the
    solver's device."""

    x: Any
    y: Any
    d: Any
    status: Any  # (B,) SolverStatus values
    iterations: Any  # segments per lane
    rho: Any
    num_integration_steps: Any
    num_newton_steps: Any
    units: Any = None  # work units per lane (step attempts and probes)

    @property
    def success(self):
        return self.status == int(SolverStatus.Optimal)


class ShardedIntegrationSolver:
    """The continuous-engine sweep sharded over ``mesh``, a sequence of
    torch devices (default: every visible CUDA device), as
    ``parallel.ShardedSolver`` shards the discrete one.

    The batch is split into ``len(mesh)`` contiguous shards; each shard's
    lanes run the flat engine's chunks (``FlatRunner.chunk``) on its device,
    with no exchange between shards inside a chunk and no compaction, and
    the host reads between chunks whether any lane of any shard still runs.
    ``params.time_limit`` is checked there.  A lane's steps do not depend on
    the width of its stack, so every lane equals the same lane of a
    ``BatchedIntegrationSolver`` bit for bit."""

    def __init__(self, problem, params=None, mesh=None):
        from ..parallel.shard import resolve_mesh

        self.mesh = resolve_mesh(mesh)
        self.num_devices = len(self.mesh)
        self._solvers = {d: BatchedIntegrationSolver(problem, params, device=d) for d in dict.fromkeys(self.mesh)}
        self.batched = self._solvers[self.mesh[0]]
        self.params = self.batched.params

    def solve(self, x0s, y0s=None) -> BatchedIntegrationResult:
        from ..parallel.shard import concat_lanes, run_per_device

        mesh, nd = self.mesh, self.num_devices
        x0s = x0s if torch.is_tensor(x0s) else np.asarray(x0s)
        B = x0s.shape[0]
        if B % nd != 0:
            raise ValueError(f"batch size {B} must be divisible by the mesh size {nd} (pad the batch)")
        per = B // nd

        def init(k, rows):
            solver = self._solvers[mesh[k]]
            dtype, device = self.params.dtype, solver.device
            x0 = torch.as_tensor(x0s[rows], dtype=dtype, device=device)
            if y0s is None:
                y0 = torch.zeros((per, solver.inner.orig_problem.num_cons), dtype=dtype, device=device)
            else:
                y0 = torch.as_tensor(y0s[rows], dtype=dtype, device=device)
            x, y = vmap(solver.inner.transform.transform_sol)(x0, y0)
            return solver.runner.init(x, y)

        states = [init(k, slice(k * per, (k + 1) * per)) for k in range(nd)]
        timer = Timer(self.params.time_limit)
        while True:
            states = run_per_device(mesh, lambda k, s: self._solvers[mesh[k]].runner.chunk(s), states)
            if not any(any_running(s["status"] == RUNNING, "flat") for s in states):
                break
            if timer.reached_time_limit():
                states = [
                    dict(s, status=torch.where(s["status"] == RUNNING, int(SolverStatus.TimeLimit), s["status"]))
                    for s in states
                ]
                break

        parts = []
        for k, s in enumerate(states):
            xr, yr, dr = self._solvers[mesh[k]]._post(s["z"])
            parts.append(
                BatchedIntegrationResult(
                    x=xr,
                    y=yr,
                    d=dr,
                    status=s["status"],
                    iterations=s["iteration"],
                    rho=s["rho"],
                    num_integration_steps=s["steps"],
                    num_newton_steps=s["newtons"],
                    units=s["units"],
                )
            )
        return concat_lanes(parts, mesh[0])


class BatchedIntegrationSolver:
    """Solves a batch of instances of one problem with the continuous
    engine, all lanes on ``device``: without one the current CUDA device,
    and the constructor raises ``RuntimeError`` when there is no card (CPU
    use passes ``device="cpu"``)."""

    def __init__(self, problem, params: Optional[Params] = None, device=None):
        self.inner = IntegrationSolver(problem, params or Params(), device=device)
        self.params = self.inner.params
        self.device = self.inner.device

        inner = self.inner
        self.fns = lane_fns(inner.fns)
        ctx = fl.FlowCtx(fns=self.fns, lb=inner.lb, ub=inner.ub)
        cfg = inner.cfg._replace(ctx=ctx)
        self.runner = FlatRunner(cfg, self.fns, inner.lb, inner.ub, self.params, inner.every)
        self.tiers = []  # the tier of every chunk of the last solve

    def _post(self, z):
        inner = self.inner
        x, y = z[:, : inner.ctx.n], z[:, inner.ctx.n :]
        it = evaluate_iterate(self.fns, x, y)
        d = bounds_dual(it, inner.lb, inner.ub, self.params.active_tol)
        return inner.transform.restore_sol(it.x, it.y, d)

    def solve(self, x0s, y0s=None) -> BatchedIntegrationResult:
        params = self.params
        dtype, device = params.dtype, self.device
        x0s = torch.as_tensor(x0s, dtype=dtype, device=device)
        B = x0s.shape[0]
        if y0s is None:
            y0s = torch.zeros((B, self.inner.orig_problem.num_cons), dtype=dtype, device=device)
        else:
            y0s = torch.as_tensor(y0s, dtype=dtype, device=device)

        x, y = vmap(self.inner.transform.transform_sol)(x0s, y0s)
        states = self.runner.init(x, y)
        timer = Timer(params.time_limit)
        self.tiers = []

        final = {k: torch.empty_like(v) for k, v in states.items() if k in _HARVEST_KEYS}
        active_orig = np.arange(B)

        def harvest(rows_local, rows_orig, states, timed_out=False):
            local = torch.as_tensor(rows_local, device=device)
            orig = torch.as_tensor(rows_orig, device=device)
            for k in _HARVEST_KEYS:
                final[k][orig] = states[k][local]
            if timed_out:
                status = final["status"][orig]
                final["status"][orig] = torch.where(status == RUNNING, int(SolverStatus.TimeLimit), status)

        while active_orig.size:
            L = int(active_orig.size)
            tier = max(_MIN_TIER, 1 << (L - 1).bit_length())
            if tier > L:
                # pad with frozen copies of lane 0
                pad = tier - L
                states = {k: torch.cat([v, v[:1].expand((pad,) + v.shape[1:])]) for k, v in states.items()}
                states["status"][L:] = int(SolverStatus.IterationLimit)
            self.tiers.append(tier)

            states = self.runner.chunk(states)
            status = states["status"][:L].cpu().numpy()
            done_local = np.where(status != RUNNING)[0]

            if timer.reached_time_limit():
                harvest(np.arange(L), active_orig, states, timed_out=True)
                break

            if done_local.size:
                harvest(done_local, active_orig[done_local], states)
                keep = np.where(status == RUNNING)[0]
                active_orig = active_orig[keep]
                if active_orig.size:
                    keep_dev = torch.as_tensor(keep, device=device)
                    states = {k: v[keep_dev] for k, v in states.items()}
            else:
                states = {k: v[:L] for k, v in states.items()}

        xr, yr, dr = self._post(final["z"])
        return BatchedIntegrationResult(
            x=xr,
            y=yr,
            d=dr,
            status=final["status"],
            iterations=final["iteration"],
            rho=final["rho"],
            num_integration_steps=final["steps"],
            num_newton_steps=final["newtons"],
            units=final["units"],
        )

