"""Multi-start global optimisation (counterpart of
``pygradflow_tpu/parallel/multistart.py``).

A nonconvex NLP reaches different KKT points from different starts: solve
every start in lockstep with ``BatchedSolver`` and keep the optimal lane of
lowest objective.
"""

from typing import Optional

import torch
from torch.func import vmap

from ..params import Params
from ..problem import Problem
from ..status import SolverStatus
from .batch import BatchedSolver, BatchResult


class MultistartResult:
    """The batch, each lane's objective (``objs``) and the index of the
    best optimal lane (``best_index``, ``None`` when no lane is optimal)."""

    def __init__(self, batch: BatchResult, objs, best: Optional[int]):
        self.batch = batch
        self.objs = objs
        self.best_index = best

    @property
    def success(self):
        return self.best_index is not None

    @property
    def x(self):
        return self.batch.x[self.best_index]

    @property
    def y(self):
        return self.batch.y[self.best_index]

    @property
    def obj(self):
        return self.objs[self.best_index]

    @property
    def num_optimal(self):
        return int(self.batch.success.sum())


def multistart_solve(
    problem: Problem,
    x0s,
    params: Optional[Params] = None,
    y0s=None,
    device=None,
) -> MultistartResult:
    """Solve from every row of ``x0s`` in lockstep on ``device`` (the card
    when ``None``); the result exposes the optimal point of lowest
    objective, each lane's objective from ``torch.func.vmap`` of
    ``problem.obj``."""
    batch = BatchedSolver(problem, params, device=device).solve(x0s, y0s)
    objs = vmap(problem.obj)(batch.x)

    ok = batch.status == int(SolverStatus.Optimal)
    if not bool(ok.any()):
        return MultistartResult(batch, objs, None)
    masked = torch.where(ok, objs, torch.inf)
    return MultistartResult(batch, objs, int(torch.argmin(masked)))
