"""Mixed-precision batched sweeps: an f32 bulk stage, then an f64 polish
(counterpart of ``pygradflow_tpu/parallel/mixed.py``).

1. The whole batched homotopy loop runs in f32 to ``f32_tol`` (default
   1e-4), with the single-precision floor on lambda;
2. every lane's (x, y) is promoted to f64 and warm-starts the f64 batched
   loop to the target ``params.opt_tol``: a few polish iterations instead
   of the whole trajectory.  A lane whose f32 stage ended with non-finite
   values restarts from its own x0.

Both stages are ``BatchedSolver`` runs on one device; the iteration counts
of a lane are the sums of its two stages.
"""

from dataclasses import replace
from typing import Optional

import torch

from ..params import Params, Precision
from ..problem import Problem
from ..solver import resolve_device
from .batch import BatchedSolver, BatchResult


class MixedPrecisionSolver:
    """Batched solver running an f32 bulk stage, then an f64 polish stage.

    ``params`` is the target configuration (f64, the final ``opt_tol``);
    the f32 stage takes it with ``precision=Single``, ``opt_tol=f32_tol``
    and ``lamb_min`` at least 1e-6 (reference ``params.py:210-211``).
    ``device`` is where both stages run: the current CUDA device when it is
    ``None``, and the constructor raises without a card (CPU use passes
    ``device="cpu"``).  After ``solve``, ``bulk_result`` holds the f32
    stage's result.
    """

    def __init__(
        self,
        problem: Problem,
        params: Optional[Params] = None,
        f32_tol: float = 1e-4,
        compact: Optional[bool] = None,
        device=None,
    ):
        if params is None:
            params = Params()
        if params.precision != Precision.Double:
            raise ValueError("MixedPrecisionSolver polishes in f64; pass f64 target params")
        self.params = params
        self.device = resolve_device(device)
        p32 = replace(
            params,
            precision=Precision.Single,
            opt_tol=float(f32_tol),
            lamb_min=max(params.lamb_min, 1e-6),
        )
        self.bulk = BatchedSolver(problem, p32, compact=compact, device=self.device)
        self.polish = BatchedSolver(problem, params, compact=compact, device=self.device)
        self.bulk_result = None

    def solve(self, x0, y0=None, data=None) -> BatchResult:
        """``x0``: (B, n) starts, numpy or tensors on the solver's device;
        ``y0``: (B, m) or None; ``data``: a parametric problem's batch."""
        x0 = torch.as_tensor(x0, dtype=torch.float64, device=self.device)
        if y0 is None:
            y0 = torch.zeros(
                (x0.shape[0], self.bulk.orig_problem.num_cons), dtype=torch.float64, device=self.device
            )
        else:
            y0 = torch.as_tensor(y0, dtype=torch.float64, device=self.device)

        r32 = self.bulk.solve(x0, y0, data=data)
        self.bulk_result = r32

        # promote: the f32 solutions as f64 warm starts; a lane that ended
        # non-finite restarts from its own start
        x_warm = r32.x.to(torch.float64)
        y_warm = r32.y.to(torch.float64)
        bad = ~(torch.isfinite(x_warm).all(dim=1) & torch.isfinite(y_warm).all(dim=1))
        x_warm = torch.where(bad[:, None], x0, x_warm)
        y_warm = torch.where(bad[:, None], y0, y_warm)

        r64 = self.polish.solve(x_warm, y_warm, data=data)
        return r64._replace(
            iterations=r64.iterations + r32.iterations,
            accepted_steps=r64.accepted_steps + r32.accepted_steps,
        )
