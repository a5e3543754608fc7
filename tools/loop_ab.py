#!/usr/bin/env python3
"""Time whole solves of two or more checkouts of this repository in turns,
so that two versions of the solve loop are compared within one run.

    python3 tools/loop_ab.py --device cpu PARENT_ROOT . . PARENT_ROOT
    python3 tools/loop_ab.py --device cuda PARENT_ROOT . . PARENT_ROOT

Each ROOT is timed in its own process, in the order given.  On the CPU
the cases are HS71 (``runners/hs.py``) at ``Params()`` (DistanceRatio
with the simplified Newton), under the Exact step control and under the
Globalized Newton, each with ``iteration_limit=60`` (the Globalized solve
does not end before it); on the card the pendulum at N=128 through MINRES
(``step_solver_type="Symmetric"``, as chip_smoke's phase 9 (c)).  For
each case the script prints the status, the iterations, the minimum and
the maximum of the walls of ``--runs`` solves after one warm-up, and ms
per iteration at the minimum: one JSON object per root.  On the card it
also prints the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys

CHILD = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
from pygradflow_torch import LinearSolverType, NewtonType, Params, Solver, StepControlType
from pygradflow_torch.runners.control import PendulumControl
from pygradflow_torch.runners.hs import HS_BY_NAME

device, runs = sys.argv[2], int(sys.argv[3])
if device == "cpu":
    torch.set_num_threads(1)
    spec = HS_BY_NAME["hs71"]
    problem, x0 = spec.problem(), np.asarray(spec.x0)
    cases = {
        "hs71 Params()": (problem, x0, Params(iteration_limit=60)),
        "hs71 Exact": (problem, x0, Params(step_control_type=StepControlType.Exact, iteration_limit=60)),
        "hs71 Globalized": (problem, x0, Params(newton_type=NewtonType.Globalized, iteration_limit=60)),
    }
else:
    problem = PendulumControl(N=128)
    params = Params(linear_solver_type=LinearSolverType.MINRES, step_solver_type="Symmetric",
                    iteration_limit=3000, validate_input=False)
    cases = {"pendulum N=128 MINRES": (problem, problem.x0_trajectory(), params)}
out = {"root": sys.argv[1]}
for name, (problem, x0, params) in cases.items():
    solver = Solver(problem, params, device=device)
    res = solver.solve(x0)  # warm-up: kernels built, graphs captured
    walls = []
    for _ in range(runs):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(x0)
        if device != "cpu":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out[name] = dict(status=res.status.name, iterations=res.iterations, wall_min=min(walls),
                     wall_max=max(walls), ms_per_iteration=1e3 * min(walls) / max(1, res.iterations))
    print(name, out[name], file=sys.stderr, flush=True)
print(json.dumps(out), flush=True)
"""


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("roots", nargs="+")
    args = parser.parse_args()
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)
    rc = 0
    for root in args.roots:
        done = subprocess.run([sys.executable, "-c", CHILD, root, args.device, str(args.runs)])
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
