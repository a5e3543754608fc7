#!/usr/bin/env python3
"""Run the PyTorch port of pygradflow once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the exit code is not 0):

1. device: the card's name and power limit, from nvidia-smi;
2. build: the hand-written kernels of ``pygradflow_torch/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, on
   saddle matrices made with numpy from a seed: the lower triangle of the
   packed factor to rtol = atol = 2e-3, the inertia exactly, the f64
   refined solve to |Ax - b|_inf <= 1e-9, NaN for a zero pivot, and the
   median of CUDA-event times over 10 runs after a warm-up.  The batched
   kernel also equals the right-looking kernel on every instance bit for
   bit, leaves NaN only in the lane of a zero pivot, and is timed beside B
   sequential calls of the right-looking kernel;
4. slice: the pendulum swing-up at N = 128 (KKT 644, right-looking kernel)
   and N = 256 (KKT 1284, left-looking kernel) solved by ``Solver`` on the
   card with the mixed-precision LDL^T tier, held against the port's own CPU
   run: status, iteration and accepted-step counts equal, x to 1e-6, and
   the launch counters showing which kernel served each solve;
5. fleet: a pendulum MPC fleet, ``BatchedSolver`` on 128 lanes of
   ``PendulumControl(N=64)`` (KKT 324, batched kernel) with perturbed start
   points, its first 8 lanes held against the port's CPU run of those lanes,
   every lane finite, only the batched kernel launched;
6. headline: ``BatchedSolver`` on 16384 lanes of Rosenbrock at ``Params()``
   (the LU tier, compaction on), every lane Optimal, the first 8 lanes held
   against the CPU run; then, with a harvest every 8 iterations so that the
   batch shrinks through its tiers, against the run without compaction:
   equal status and counts, and whether x is bitwise equal.

The last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``.  Without a card, or run outside a
checkout of the repository, the script exits with 1 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 7
TOL = 2e-3  # packed f32 factors of two summation orders (tests/test_pallas_ldlt.py)
RES_TOL = 1e-9
X_TOL = 1e-6
# (n, m) of each saddle; the first of each kernel has the pendulum's shape
KERNEL_SIZES = {"rl": [(386, 258), (960, 320)], "ll": [(770, 514), (1536, 512)]}
MAIN_PATH_SIZE = {"rl": 644, "ll": 1284}  # KKT of the pendulum at N=128 / N=256
# (B, n, m) of each batched stack; the first is the fleet's (N=64, KKT 324)
BATCHED_SIZES = [(128, 194, 130), (8, 60, 20)]
KERNELS = {
    "rl": ("ldlt_factor_rl", "pygradflow_tpu/linalg/pallas_ldlt.py:112"),
    "ll": ("ldlt_factor_ll", "pygradflow_tpu/linalg/pallas_ldlt_hbm.py:162"),
    "rl_batched": ("ldlt_factor_rl_batched", "pygradflow_tpu/linalg/pallas_ldlt.py:116"),
}
FLEET_N, FLEET_B, CPU_LANES = 64, 128, 8
HEADLINE_B = 16384


def fail(msg):
    raise RuntimeError(msg)


def saddle(rng, n, m):
    import numpy as np

    h = rng.standard_normal((n, n))
    k = h @ h.T + n * np.eye(n)
    j = rng.standard_normal((m, n))
    return np.block([[k, j.T], [j, -0.1 * np.eye(m)]])


def cuda_ms(fn, runs=10):
    """Median CUDA-event time of ``fn()`` over ``runs`` calls after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_phase():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    card = out[0].strip()
    print(card, flush=True)
    return card


def build_phase():
    from pygradflow_torch import build

    build.load_library()
    print(f"build: {build.BUILD_SECONDS:.1f} s ({build.library_path().parent.name})", flush=True)


def kernel_phase(card):
    """Each kernel against its plain version on the card; returns per-kernel
    records at the main path's sizes."""
    import numpy as np
    import torch

    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.linalg.ldlt import ldlt_num_neg_eigvals
    from pygradflow_torch.linalg.two_level_ldlt import guard_factor

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    records = {}
    for key, sizes in KERNEL_SIZES.items():
        name, _ = KERNELS[key]
        kernel = getattr(lk, name)
        plain = getattr(lk, name + "_ref")
        for n, m in sizes:
            a64 = torch.tensor(saddle(rng, n, m), device=dev)
            a32 = a64.to(torch.float32).contiguous()
            packed = kernel(a32)
            ref = plain(a32)
            torch.cuda.synchronize()
            lo, lo_ref = torch.tril(packed), torch.tril(ref)
            err = (lo - lo_ref).abs().max().item()
            if not torch.allclose(lo, lo_ref, rtol=TOL, atol=TOL):
                fail(f"{name} n={n + m}: tril differs from the plain version (max abs {err:.3e})")
            neg, neg_ref = int(ldlt_num_neg_eigvals(packed)), int(ldlt_num_neg_eigvals(ref))
            if not neg == neg_ref == m:
                fail(f"{name} n={n + m}: inertia {neg} vs plain {neg_ref}, expected {m}")
            b = torch.tensor(rng.standard_normal(n + m), device=dev)
            x = lk.refine_solve(guard_factor(packed, a64), a64, b)
            res = (a64 @ x - b).abs().max().item()
            if not res <= RES_TOL:
                fail(f"{name} n={n + m}: refined residual {res:.3e} > {RES_TOL}")
            ms = cuda_ms(lambda: kernel(a32))
            plain_ms = cuda_ms(lambda: plain(a32))
            print(
                f"kernel {name} n={n + m}: max_abs_err={err:.3e} inertia={neg} "
                f"refined_res={res:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} [{card}]",
                flush=True,
            )
            if n + m == MAIN_PATH_SIZE[key]:
                records[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

        # a zero pivot inside a later panel poisons the factor with NaN
        a = saddle(rng, *sizes[0])
        k = 200
        a[k, :] = 0.0
        a[:, k] = 0.0
        a32 = torch.tensor(a, dtype=torch.float32, device=dev)
        for label, packed in (("kernel", kernel(a32)), ("plain", plain(a32))):
            if not torch.isnan(torch.diagonal(packed)[k:]).any():
                fail(f"{name}: zero pivot at {k} left no NaN in the {label} factor")
            if not torch.isnan(guard_factor(packed, a32)).all():
                fail(f"{name}: guard did not poison the {label} factor")
        print(f"kernel {name}: zero pivot at {k} gives NaN", flush=True)
    return records


def batched_kernel_phase(card):
    """The batched kernel against the right-looking kernel on each instance
    and against its plain version; returns its record at the fleet's shape."""
    import numpy as np
    import torch

    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.linalg.ldlt import ldlt_num_neg_eigvals
    from pygradflow_torch.linalg.two_level_ldlt import guard_factor

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    record = None
    for batch, n, m in BATCHED_SIZES:
        a64 = torch.tensor(np.stack([saddle(rng, n, m) for _ in range(batch)]), device=dev)
        a32 = a64.to(torch.float32).contiguous()
        packed = lk.ldlt_factor_rl_batched(a32)
        singles = [lk.ldlt_factor_rl(a32[i]) for i in range(batch)]
        ref = lk.ldlt_factor_rl_batched_ref(a32)
        torch.cuda.synchronize()
        unequal = [i for i in range(batch) if not torch.equal(packed[i], singles[i])]
        if unequal:
            fail(f"rl_batched B={batch} n={n + m}: lanes {unequal[:8]} differ from ldlt_factor_rl")
        lo, lo_ref = torch.tril(packed), torch.tril(ref)
        err = (lo - lo_ref).abs().max().item()
        if not torch.allclose(lo, lo_ref, rtol=TOL, atol=TOL):
            fail(f"rl_batched B={batch} n={n + m}: tril differs from the plain version (max abs {err:.3e})")
        neg = ldlt_num_neg_eigvals(packed).tolist()
        if neg != [m] * batch:
            fail(f"rl_batched B={batch} n={n + m}: inertia {sorted(set(neg))}, expected {m}")
        b = torch.tensor(rng.standard_normal((batch, n + m)), device=dev)
        x = lk.refine_solve(guard_factor(packed, a64), a64, b)
        res = ((a64 @ x[..., None])[..., 0] - b).abs().amax(dim=-1).max().item()
        if not res <= RES_TOL:
            fail(f"rl_batched B={batch} n={n + m}: refined residual {res:.3e} > {RES_TOL}")
        ms = cuda_ms(lambda: lk.ldlt_factor_rl_batched(a32))
        plain_ms = cuda_ms(lambda: lk.ldlt_factor_rl_batched_ref(a32))
        loop_ms = cuda_ms(lambda: [lk.ldlt_factor_rl(a32[i]) for i in range(batch)])
        print(
            f"kernel ldlt_factor_rl_batched B={batch} n={n + m}: bitwise equal to ldlt_factor_rl "
            f"on every lane, max_abs_err={err:.3e} inertia={m} refined_res={res:.3e} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} rl_loop_ms={loop_ms:.4f} [{card}]",
            flush=True,
        )
        if record is None:
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # a zero pivot in one lane poisons that lane only
    batch, n, m = BATCHED_SIZES[1]
    a = np.stack([saddle(rng, n, m) for _ in range(batch)])
    lane, k = 3, 40
    a[lane, k, :] = 0.0
    a[lane, :, k] = 0.0
    a32 = torch.tensor(a, dtype=torch.float32, device=dev)
    for label, packed in (("kernel", lk.ldlt_factor_rl_batched(a32)), ("plain", lk.ldlt_factor_rl_batched_ref(a32))):
        guarded = guard_factor(packed, a32)
        others = [i for i in range(batch) if i != lane]
        if not torch.isnan(guarded[lane]).all() or not torch.isfinite(torch.tril(guarded[others])).all():
            fail(f"rl_batched: zero pivot in lane {lane} did not poison that lane alone ({label})")
    print(f"kernel ldlt_factor_rl_batched: zero pivot in lane {lane} gives NaN in that lane only", flush=True)
    return record


def slice_phase(card):
    """The pendulum at N=128 and N=256 on the card against the port's CPU run;
    returns the launch counts of the main path's run."""
    import numpy as np
    import torch

    from pygradflow_torch import LinearSolverType, Params, Solver, SolverStatus
    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.runners.control import PendulumControl

    params = Params(
        linear_solver_type=LinearSolverType.PallasLDLT,
        iteration_limit=3000,
        validate_input=False,
    )
    expect = {128: "rl", 256: "ll"}
    cpu = {}
    for N in expect:
        problem = PendulumControl(N=N)
        cpu[N] = Solver(problem, params, device="cpu").solve(problem.x0_trajectory())

    for key in lk.LAUNCHES:
        lk.LAUNCHES[key] = 0
    totals = dict.fromkeys(lk.LAUNCHES, 0)
    for N, key in expect.items():
        problem = PendulumControl(N=N)
        x0 = torch.tensor(problem.x0_trajectory(), device="cuda")
        for run in ("first", "repeat"):
            before = dict(lk.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = Solver(problem, params, device="cuda").solve(x0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            used = {k: lk.LAUNCHES[k] - before[k] for k in before}
            ref = cpu[N]
            x = res.x.cpu().numpy()
            if res.status != SolverStatus.Optimal or ref.status != SolverStatus.Optimal:
                fail(f"N={N}: status {res.status.name} on cuda, {ref.status.name} on cpu")
            if (res.iterations, res.num_accepted_steps) != (ref.iterations, ref.num_accepted_steps):
                fail(
                    f"N={N}: {res.iterations}/{res.num_accepted_steps} iterations/accepted "
                    f"on cuda, {ref.iterations}/{ref.num_accepted_steps} on cpu"
                )
            if not np.isfinite(x).all() or x.shape != (problem.num_vars,):
                fail(f"N={N}: solution not finite or of the wrong shape")
            dx = np.abs(x - ref.x.cpu().numpy()).max()
            if not dx <= X_TOL:
                fail(f"N={N}: x differs from the cpu run by {dx:.3e}")
            other = [k for k in used if k != key]
            if used[key] == 0 or any(used[k] != 0 for k in other):
                fail(f"N={N}: launches {used}, expected only {key!r}")
            print(
                f"slice N={N} ({run}): {res.status.name} {res.iterations}/"
                f"{res.num_accepted_steps} launches={used} |x-x_cpu|={dx:.3e} "
                f"wall={wall:.3f} s ms/iter={1e3 * wall / res.iterations:.2f} [{card}]",
                flush=True,
            )
            for k in totals:
                totals[k] += used[k]
    return totals


def _check_lanes(label, res, ref, lanes):
    """Lanes ``lanes`` of a card result against a CPU result."""
    import numpy as np

    for field in ("status", "iterations", "accepted_steps"):
        ours, theirs = getattr(res, field)[lanes].tolist(), getattr(ref, field).tolist()
        if ours != theirs:
            fail(f"{label}: {field} {ours} on cuda, {theirs} on cpu")
    dx = np.abs(res.x[lanes].cpu().numpy() - ref.x.numpy()).max()
    if not dx <= X_TOL:
        fail(f"{label}: x differs from the cpu run by {dx:.3e}")
    return dx


def fleet_phase(card):
    """The pendulum MPC fleet through the batched kernel; returns the launch
    counts of the main path's runs."""
    import numpy as np
    import torch

    from pygradflow_torch import LinearSolverType, Params, SolverStatus
    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.parallel import BatchedSolver
    from pygradflow_torch.runners.control import PendulumControl

    params = Params(
        linear_solver_type=LinearSolverType.PallasLDLT,
        iteration_limit=3000,
        validate_input=False,
    )
    problem = PendulumControl(N=FLEET_N)
    rng = np.random.default_rng(0)
    x0 = problem.x0_trajectory()[None, :] + 0.02 * rng.standard_normal((FLEET_B, problem.num_vars))
    cpu = BatchedSolver(problem, params, device="cpu").solve(x0[:CPU_LANES])

    x0_dev = torch.tensor(x0, device="cuda")
    for key in lk.LAUNCHES:
        lk.LAUNCHES[key] = 0
    for run in ("first", "repeat"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = BatchedSolver(problem, params, device="cuda").solve(x0_dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dx = _check_lanes(f"fleet ({run})", res, cpu, slice(0, CPU_LANES))
        if not torch.isfinite(res.x).all() or tuple(res.x.shape) != (FLEET_B, problem.num_vars):
            fail("fleet: solutions not finite or of the wrong shape")
        optimal = int((res.status == int(SolverStatus.Optimal)).sum())
        iters = int(res.iterations.max())
        print(
            f"fleet N={FLEET_N} B={FLEET_B} ({run}): {optimal}/{FLEET_B} Optimal, lockstep "
            f"iterations {iters}, lanes 0-{CPU_LANES - 1} {res.iterations[0].item()}/"
            f"{res.accepted_steps[0].item()} |x-x_cpu|={dx:.3e} wall={wall:.3f} s "
            f"solves/s={FLEET_B / wall:.1f} ms/iter={1e3 * wall / iters:.2f} [{card}]",
            flush=True,
        )
    used = dict(lk.LAUNCHES)
    if used["rl_batched"] == 0 or used["rl"] != 0 or used["ll"] != 0:
        fail(f"fleet: launches {used}, expected only 'rl_batched'")
    print(f"fleet launches: {used}", flush=True)
    return used


def headline_phase(card):
    """Batched Rosenbrock at B=16384 through the LU tier."""
    import numpy as np
    import torch

    from pygradflow_torch import Params, SolverStatus
    from pygradflow_torch.parallel import BatchedSolver
    from tests.torch_parity import Rosenbrock

    params = Params(validate_input=False, jit_chunk=128)
    x0 = np.random.default_rng(0).uniform(-1.5, 1.5, size=(HEADLINE_B, 2))
    cpu = BatchedSolver(Rosenbrock(), params, device="cpu").solve(x0[:CPU_LANES])
    x0_dev = torch.tensor(x0, device="cuda")
    for run in ("first", "repeat"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = BatchedSolver(Rosenbrock(), params, device="cuda").solve(x0_dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        optimal = int((res.status == int(SolverStatus.Optimal)).sum())
        if optimal != HEADLINE_B:
            fail(f"headline: {optimal}/{HEADLINE_B} lanes Optimal")
        dx = _check_lanes(f"headline ({run})", res, cpu, slice(0, CPU_LANES))
        print(
            f"headline Rosenbrock B={HEADLINE_B} ({run}): {optimal}/{HEADLINE_B} Optimal, "
            f"iterations max {int(res.iterations.max())} median "
            f"{int(res.iterations.median())}, |x-x_cpu|={dx:.3e} wall={wall:.3f} s "
            f"solves/s={HEADLINE_B / wall:.1f} [{card}]",
            flush=True,
        )

    # compaction only permutes lanes; batched BLAS may pick other algorithms
    # at other widths, so x is held to X_TOL and its bitwise equality reported
    plain = BatchedSolver(Rosenbrock(), params, device="cuda", compact=False).solve(x0_dev)
    shrunk = BatchedSolver(Rosenbrock(), params, device="cuda", compact=True, harvest_chunk=8).solve(x0_dev)
    for field in ("status", "iterations", "accepted_steps"):
        if not torch.equal(getattr(plain, field), getattr(shrunk, field)):
            fail(f"headline: compaction changed {field}")
    dx = (plain.x - shrunk.x).abs().max().item()
    if not dx <= X_TOL:
        fail(f"headline: compaction moved x by {dx:.3e}")
    print(
        f"headline compaction (harvest every 8): counts equal, x bitwise equal: "
        f"{torch.equal(plain.x, shrunk.x) and torch.equal(plain.y, shrunk.y)}, "
        f"max |dx| {dx:.3e}",
        flush=True,
    )


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "pygradflow_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = device_phase()
    build_phase()
    records = kernel_phase(card)
    records["rl_batched"] = batched_kernel_phase(card)
    launches = slice_phase(card)
    launches["rl_batched"] = fleet_phase(card)["rl_batched"]
    headline_phase(card)

    summary = []
    for key, (name, replaces) in KERNELS.items():
        if launches[key] == 0:
            fail(f"{name} was not launched by the main path")
        summary.append(
            dict(
                name=name,
                route="cuda",
                source="pygradflow_torch/csrc/ldlt.cu",
                replaces=replaces,
                launches=launches[key],
                **records[key],
            )
        )
    print(json.dumps({"kernels": summary}))
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
