#!/usr/bin/env python3
"""The continuous engine's counts on the CPU under three kinds of
arithmetic, to see whether the port's two deliberate roundings part it
from the JAX package.

    python3 tools/integration_rounding.py

The port sums axes of at most ``util.UNROLL_MAX`` entries left to right in
elementwise operations and rounds the step-size factor to a multiple of
``integrator.FACTOR_QUANTUM``, so that a lane, a single solve, the CPU and
a card take the same steps.  Each variant runs in its own process with
those patched out at run time:

- ``port``: the port as it is;
- ``no-quantum``: the step factor not rounded;
- ``no-quantum-library-sums``: that, and every such sum through the
  library's own reduction (``torch.sum``, ``@``).

For each variant the script prints one JSON object: status, segments,
integration steps and Newton steps of HS71 under SDIRK4 (host engine),
of the four HS71 lanes of ``tests/test_integration_batch.py:37-55``
(TR-BDF2) and of lanes 0-7 of ``benchmarks/bench_integration_batch.py``'s
batch (SDIRK4), with the seconds each took.  The JAX package's counts of
the same runs are held in ``tests/test_torch_integration_solver.py`` and
``tests/test_torch_integration_batch.py``.  Runs on the CPU, about a
minute with the three variants in parallel.
"""

import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("port", "no-quantum", "no-quantum-library-sums")
RUNS = ("hs71 sdirk4", "four lanes", "bench lanes")


def _patch(variant):
    import torch

    from pygradflow_torch import util
    from pygradflow_torch.integration import flat_loop, flow, integrator

    if variant == "port":
        return

    def controller_factor(err_ratio, ok, exponent, cap):
        factor = torch.where(err_ratio > 0.0, 0.9 * err_ratio**exponent, cap)
        return torch.where(ok, torch.clamp(factor, 0.2, cap), 0.5)

    integrator.controller_factor = flat_loop.controller_factor = controller_factor
    if variant == "no-quantum-library-sums":
        util.UNROLL_MAX = 0
        flow.UNROLL_MAX = 0


def _run(args):
    variant, run = args
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    torch.set_num_threads(1)
    _patch(variant)
    import tests.torch_parity as tp
    from pygradflow_torch import IntegrationMethod, Params, SolverStatus
    from pygradflow_torch.integration import BatchedIntegrationSolver, IntegrationSolver

    base = dict(iteration_limit=1000, rho=1e-2)
    hs71 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])
    t0 = time.perf_counter()
    if run == "hs71 sdirk4":
        params = Params(**base, integration_method=IntegrationMethod.SDIRK4)
        r = IntegrationSolver(tp.HS71Explicit(), params, device="cpu").solve(torch.tensor(hs71), torch.zeros(2, dtype=torch.float64))
        counts = [[r.status.name, r.iterations, r.num_integration_steps, r.num_newton_steps]]
    else:
        if run == "four lanes":
            x0s = np.tile(hs71, (4, 1))
            x0s[1, 1], x0s[2, 2], x0s[3, 0] = 4.5, 4.0, 2.0
            params = Params(**base)
        else:
            rng = np.random.default_rng(7)
            x0s = np.clip(hs71[None, :] + rng.uniform(-0.1, 0.1, size=(8, 5)), [1.0, 1, 1, 1, 0], [5.0, 5, 5, 5, 2])
            params = Params(**base, integration_max_steps=50_000, integration_method=IntegrationMethod.SDIRK4)
        r = BatchedIntegrationSolver(tp.HS71Explicit(), params, device="cpu").solve(torch.tensor(x0s))
        counts = [
            [SolverStatus(int(s)).name, int(i), int(k), int(n)]
            for s, i, k, n in zip(r.status, r.iterations, r.num_integration_steps, r.num_newton_steps)
        ]
    return variant, run, counts, time.perf_counter() - t0


def main():
    jobs = [(v, r) for v in VARIANTS for r in RUNS]
    # one process per run: a variant's patches stay in its process
    spawn = multiprocessing.get_context("spawn")
    with spawn.Pool(min(len(jobs), os.cpu_count() or 1), maxtasksperchild=1) as pool:
        results = pool.map(_run, jobs)
    for variant in VARIANTS:
        out = {"variant": variant}
        for v, run, counts, seconds in results:
            if v == variant:
                out[run] = counts
                out[run + " s"] = round(seconds, 1)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
