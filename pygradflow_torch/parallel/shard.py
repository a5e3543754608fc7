"""Instance sweeps sharded over several devices (counterpart of
``pygradflow_tpu/parallel/shard.py``).

The batch is split into ``len(mesh)`` contiguous shards, one per entry of
the mesh, a sequence of torch devices.  Each shard runs the lane loop of
``parallel/batch.py`` on its device for ``params.jit_chunk`` iterations,
with no compaction; between chunks the host reads whether any lane of any
shard still runs, where the JAX package takes a ``psum`` of the shards'
running-lane counts.  A terminal lane is frozen, so the result does not
depend on when that vote comes, and each lane equals the same lane of a
``BatchedSolver`` bit for bit.

A device may appear more than once in the mesh (``["cuda:0"] * 4``), as a
simulated mesh does for the JAX package; shards on one device run one
after the other.  Where the mesh holds several distinct devices, each
device's shards run in a host thread of their own, so the devices work
concurrently.
"""

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Optional, Sequence

import numpy as np
import torch

from ..params import Params
from ..problem import Problem
from ..solver import _resolve_device
from ..status import RUNNING
from ..timer import Timer
from .batch import BatchedSolver, BatchResult, LaneLoop, _time_out


def default_mesh():
    """Every visible CUDA device; raises, as the entry points do, when there
    is none (CPU use passes a mesh such as ``["cpu"] * 4``)."""
    if not torch.cuda.is_available():
        _resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_mesh(mesh) -> list:
    return [_resolve_device(d) for d in (default_mesh() if mesh is None else mesh)]


def concat_lanes(parts, device):
    """The (Named)tuples of per-shard tensors ``parts`` joined along the lane
    axis on ``device``; None fields stay None."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        vals = [concat_lanes(list(leaves), device) for leaves in zip(*parts)]
        return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)
    return torch.cat([p.to(device) for p in parts])


def run_per_device(mesh, fn, items):
    """``fn(k, item)`` for every shard ``k``: in order on one device, and
    in one host thread per device when the mesh holds several."""
    devices = list(dict.fromkeys(mesh))
    if len(devices) == 1:
        return [fn(k, item) for k, item in enumerate(items)]
    out = [None] * len(items)

    def work(device):
        with torch.cuda.device(device) if device.type == "cuda" else nullcontext():
            for k, item in enumerate(items):
                if mesh[k] == device:
                    out[k] = fn(k, item)

    with ThreadPoolExecutor(len(devices)) as pool:
        for future in [pool.submit(work, d) for d in devices]:
            future.result()
    return out


class ShardedSolver:
    """Solves an instance batch sharded over ``mesh`` (default: every
    visible CUDA device)."""

    def __init__(self, problem: Problem, params: Optional[Params] = None, mesh: Optional[Sequence] = None):
        self.mesh = resolve_mesh(mesh)
        self.num_devices = len(self.mesh)
        self._solvers = {d: BatchedSolver(problem, params, compact=False, device=d) for d in dict.fromkeys(self.mesh)}
        self.batched = self._solvers[self.mesh[0]]
        self.params = self.batched.params
        self.parametric = self.batched.parametric
        # each shard's lane loop, built once and reused across solves, as
        # the JAX package keeps its compiled shard_map per structure
        self._loops = {}

    def _loop(self, k) -> LaneLoop:
        loop = self._loops.get(k)
        if loop is None:
            solver = self._solvers[self.mesh[k]]
            loop = self._loops[k] = LaneLoop(solver.transform, self.params, solver.device)
        return loop

    @staticmethod
    def _host_rows(a):
        return None if a is None else (a if torch.is_tensor(a) else np.asarray(a))

    def _check_batch(self, batch, parts):
        if batch % parts != 0:
            raise ValueError(f"batch size {batch} must be divisible by the mesh size {parts} (pad the batch)")

    def _init_shards(self, x0, y0, data, rows=None):
        """The initial lane states of each shard of the rows ``rows`` of the
        batch (all rows when None); each shard's loop is bound to its data."""
        nd = self.num_devices
        x0, y0 = self._host_rows(x0), self._host_rows(y0)
        data = None if data is None else tuple(self._host_rows(a) for a in data)
        batch = x0.shape[0] if rows is None else rows.stop - rows.start
        start = 0 if rows is None else rows.start
        self._check_batch(batch, nd)
        per = batch // nd
        states = []
        for k, device in enumerate(self.mesh):
            r = slice(start + k * per, start + (k + 1) * per)
            solver = self._solvers[device]
            data_k = solver._data(None if data is None else tuple(a[r] for a in data))
            x, y = solver._initial(x0[r], None if y0 is None else y0[r], data_k)
            loop = self._loop(k)
            if self.parametric:
                loop.bind(data_k)
            states.append(loop.init_state(x, y))
        return states

    def _chunk(self, states):
        chunk = self.params.jit_chunk
        return run_per_device(self.mesh, lambda k, s: self._loop(k).run_chunk(s, chunk), states)

    @staticmethod
    def _local_running(states) -> int:
        """The running lanes over the shards: the host's vote."""
        return sum(int(torch.count_nonzero(s.status == RUNNING)) for s in states)

    def _finalize(self, states) -> BatchResult:
        # each shard's loop is still bound to that shard's data
        parts = [self._loop(k).finalize(state) for k, state in enumerate(states)]
        return concat_lanes(parts, self.mesh[0])

    def solve(self, x0, y0=None, data=None) -> BatchResult:
        """Solve the batch: ``x0`` (B, n), ``y0`` (B, m) or None, ``data`` a
        tuple of (B, ...) arrays for a parametric problem; B must divide
        over the mesh.  The result lies on the mesh's first device."""
        states = self._init_shards(x0, y0, data)
        timer = Timer(self.params.time_limit)
        while True:
            states = self._chunk(states)
            if self._local_running(states) == 0:
                break
            if timer.reached_time_limit():
                states = [_time_out(s) for s in states]
                break
        return self._finalize(states)
