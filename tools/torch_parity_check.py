"""Parity harness: the PyTorch port against the JAX package on the cases of
``tools/torch_parity_cases.py`` (those of ``benchmarks/parity_check.py``).

    python3 tools/torch_parity_check.py --side jax [--workers 4]
    python3 tools/torch_parity_check.py --side torch --device cpu [--workers 4]
    python3 tools/torch_parity_check.py --side torch --device cuda

``--side jax`` runs the JAX package on the CPU and writes one row per case
(status, iterations, accepted steps, x, y, the objective at x, and segments
and steps for the continuous engine) to ``tools/torch_parity_jax.json``.
``--side torch`` runs the port on ``--device`` and holds each row against
that file: equal status and counts, x and y within 1e-8 on the CPU and
1e-6 on the card (relative to max(1, |x|)); a case listed in
``EXPECTED_PARTINGS`` is held to an equal status and, when Optimal,
objectives within 1e-6.  It prints one line per case and exits 1 when any
case fails.  ``--cases`` picks cases by name, ``--max-iterations K`` those
whose JAX run took at most K iterations, and ``--rows`` another file of
JAX rows.
"""

import argparse
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tools import torch_parity_cases as pc  # noqa: E402

JAX_ROWS = os.path.join(ROOT, "tools", "torch_parity_jax.json")


def _jax_problem(case):
    import numpy as np

    from pygradflow_tpu.problem import Problem

    if case.kind == "hs":
        from pygradflow_tpu.runners.hs import HS_BY_NAME

        spec = HS_BY_NAME[case.problem]
        problem = spec.problem()
        return problem, *pc.hs_start(spec)
    if case.kind == "pendulum":
        from pygradflow_tpu.runners.control import PendulumControl

        problem = PendulumControl(N=int(case.problem[len("pendulum"):]))
        return problem, problem.x0_trajectory(), None

    from tests.problems import HS71, Rosenbrock, Tame

    class Simple(Problem):
        def __init__(self):
            super().__init__(np.array([-np.inf]), np.array([np.inf]))

        def obj(self, x):
            return 0.5 * x[0] ** 2

    class Unbounded(Problem):
        def __init__(self):
            super().__init__(np.array([-np.inf]), np.array([np.inf]))

        def obj(self, x):
            return x[0]

    problem = {"rosenbrock": Rosenbrock, "hs71": HS71, "tame": Tame, "simple": Simple, "unbounded": Unbounded}[
        case.problem
    ]()
    return problem, *pc.STARTS[case.problem]


def run_jax(name):
    """The JAX package's row of the case ``name``, on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from pygradflow_tpu import Params, Solver
    from pygradflow_tpu.integration import IntegrationSolver

    case = pc.CASES[name]
    problem, x0, y0 = _jax_problem(case)
    cls = IntegrationSolver if case.kind == "integration" else Solver
    result = cls(problem, Params(**case.kwargs)).solve(x0, y0)
    x = np.asarray(result.x, dtype=np.float64)
    obj = float(problem.obj(jnp.asarray(x)))
    return pc.row(case, result, x, np.asarray(result.y), obj)


def _init_worker():
    import torch

    torch.set_num_threads(1)


def _job(args):
    side, device, name = args
    t0 = time.perf_counter()
    out = run_jax(name) if side == "jax" else pc.run_torch(name, device)
    return out, time.perf_counter() - t0


def run_cases(side, names, device="cpu", workers=1):
    """(row, seconds) of each of ``names`` on ``side``, in the order given,
    each as soon as it and those before it are done."""
    jobs = [(side, device, name) for name in names]
    if workers <= 1:
        yield from map(_job, jobs)
        return
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, initializer=_init_worker) as pool:
        yield from pool.imap(_job, jobs, chunksize=1)


def load_jax_rows(path=JAX_ROWS):
    with open(path) as f:
        return {r["case"]: r for r in json.load(f)["rows"]}


def select(names=None, max_iterations=None, rows=None):
    """The case names to run: ``names`` (default all), then only those whose
    JAX run took at most ``max_iterations`` iterations."""
    out = list(names) if names else list(pc.CASES)
    for name in out:
        if name not in pc.CASES:
            raise SystemExit(f"unknown case {name!r}")
    if max_iterations is not None:
        rows = rows or load_jax_rows()
        out = [n for n in out if rows[n]["iterations"] <= max_iterations]
    return out


def check(names, device="cpu", workers=1, rows=None, out=print):
    """Run the port on ``names`` and hold each row against the JAX rows;
    returns the list of (name, verdict, details, seconds)."""
    rows = rows or load_jax_rows()
    partings = pc.expected_partings(device)
    results = []
    for (ours, seconds) in run_cases("torch", names, device, workers):
        name = ours["case"]
        verdict, details = pc.compare(ours, rows[name], device, partings)
        results.append((name, verdict, details, seconds))
        out(pc.format_line(name, verdict, details) + f"  {seconds:.1f} s", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=["jax", "torch"], required=True)
    ap.add_argument("--device", default="cpu", help="the port's device (torch side): cpu or cuda")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--cases", nargs="*", help="case names (default: all)")
    ap.add_argument("--max-iterations", type=int, default=None)
    ap.add_argument("--rows", default=JAX_ROWS, help="the JAX rows' file, written by the jax side, read by the torch side")
    args = ap.parse_args(argv)

    if args.side == "jax":
        names = select(args.cases)
        rows = [r for r, _ in run_cases("jax", names, workers=args.workers)]
        if args.cases and os.path.exists(args.rows):
            # a partial run updates the rows it ran
            merged = load_jax_rows(args.rows)
            merged.update({r["case"]: r for r in rows})
            rows = [merged[n] for n in pc.CASES if n in merged]
        with open(args.rows, "w") as f:
            json.dump({"rows": rows}, f, indent=1)
            f.write("\n")
        for r in rows:
            print(f"{r['case']:<52s} {r['status']} {r['iterations']}/{r['accepted']}")
        print(f"wrote {len(rows)} rows to {os.path.relpath(args.rows, ROOT)}")
        return 0

    rows = load_jax_rows(args.rows)
    names = select(args.cases, args.max_iterations, rows)
    t0 = time.perf_counter()
    results = check(names, args.device, args.workers, rows)
    failed = [name for name, verdict, _, _ in results if verdict == "FAILED"]
    parted = [name for name, verdict, _, _ in results if verdict == "parted as expected"]
    print(
        f"{len(results) - len(failed) - len(parted)} equal, {len(parted)} parted as expected "
        f"({', '.join(parted) or 'none'}), {len(failed)} failed ({', '.join(failed) or 'none'}) "
        f"of {len(results)} on {args.device}, {time.perf_counter() - t0:.1f} s"
    )
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
