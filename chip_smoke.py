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
   median of CUDA-event times over 10 runs after a warm-up;
4. slice: the pendulum swing-up at N = 128 (KKT 644, right-looking kernel)
   and N = 256 (KKT 1284, left-looking kernel) solved by ``Solver`` on the
   card with the mixed-precision LDL^T tier, held against the port's own CPU
   run: status, iteration and accepted-step counts equal, x to 1e-6, and
   the launch counters showing which kernel served each solve.

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
KERNELS = {
    "rl": ("ldlt_factor_rl", "pygradflow_tpu/linalg/pallas_ldlt.py:112"),
    "ll": ("ldlt_factor_ll", "pygradflow_tpu/linalg/pallas_ldlt_hbm.py:162"),
}


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
    launches = slice_phase(card)

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
