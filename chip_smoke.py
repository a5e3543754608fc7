#!/usr/bin/env python3
"""Run the PyTorch port of pygradflow once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the exit code is not 0):

1. device: the card's name and power limit, from nvidia-smi;
2. build: the hand-written kernels of ``pygradflow_torch/csrc`` with nvcc,
   and what ``-Xptxas -v`` says of the panel-factor and update kernels
   (registers; a spill fails the run);
3. kernels: each kernel against its plain PyTorch version on the card, on
   saddle matrices made with numpy from a seed and on the matrices phase 7
   gives the kernels (built by the port's Schur step at the interleaved
   pendulum's start point: the dense dual S at N = 256, the BCR root at
   N = 1024, both diagonal blocks of the two-level factor at N = 1024, the
   fleet's BCR roots at N = 100), and the dense dual S at N = 768 (1538
   rows, B3'): the same bits from two calls, the lower triangle of the
   packed factor to rtol = atol = 2e-3, the first panel's NB columns bit
   for bit (the whole factor on a matrix that fits one panel), the inertia
   exactly, the f64 refined solve to |Ax - b|_inf <= 1e-9, NaN for a zero pivot inside
   a panel and at either side of a panel edge (k = NB - 1, NB), and the
   median of CUDA-event times over 10 runs after a warm-up, beside the
   bound (n^3 / 3 FLOPs at the f32 peak or the bytes at the memory rate)
   and, for the negative definite matrices of phase 7, the library
   yardstick ``torch.linalg.cholesky(-S)``.  The two-level factor of that
   S (2 x 1025) is held the same way against its super-blocks through B1's
   plain version.  The batched kernel also equals the right-looking kernel
   on every instance bit for bit, leaves NaN only in the lane of a zero
   pivot, and is timed beside B sequential calls of the right-looking
   kernel.  Last, torch.profiler splits one factor at n = 644 (B1'), 1284
   (B3') and (128, 324) (B2') into the device time of each CUDA kernel,
   and of each panel's diagonal-block, rows-below and update launches;
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
   equal status and counts, and whether x is bitwise equal;
7. control: the Schur tiers on ``PendulumControlInterleaved`` (BASELINE
   config #4), each card run held against the run named beside it (Optimal
   both, equal iteration and accepted-step counts, x to 1e-6) and its
   launches checked: (a) the dense dual Schur complement through the
   mixed-precision tier at N = 256 (514 rows, B1' only) against the CPU
   run; (b) the matrix-free staged tier (BCR down to a 512-row root, B1'
   only) at N = 1024 against the card's f64 staged run and the CPU run, and
   at N = 4096 against the card's f64 run; (c) the dense dual at N = 1024
   (2050 rows, the two-level factor, 2 x 1025 through B1') against the
   card's f64 dense Schur run; (d) a ``BatchedSolver`` fleet of 128 lanes at
   N = 256 (root (128, 512, 512), the panel factor, no kernel) and (e) at
   N = 100 (root (128, 256, 256), B2' only), first 8 lanes against the CPU
   run.  The f64 references launch no kernel;
8. options: the rest of the discrete loop's options on the card, each run
   held against the run named beside it (status, iteration and
   accepted-step counts equal, x to 1e-6 when Optimal) with its launches
   and launches per iteration: (a) Full, ActiveSet and Globalized Newton
   (50 iterations) and (b) the ParetoDecrease and LagrangianFilter
   penalties, the ResiduumRatio and Exact controls and GradJac scaling, on
   the pendulum at N = 128 (B1' only); (c) Full Newton at N = 256 (B3'
   only); (d) the N = 64 fleet of 128 lanes in lockstep (B2' only) under
   ActiveSet Newton and the LagrangianFilter, the Exact control, and
   Globalized Newton (20 iterations), its first 8 lanes; (e)
   ``QuadraticProblem``, the boxed Laplacian QP at n = 1000 (m = 0, B1'
   only) under ActiveSet Newton; each against the port's CPU run, which
   worker processes compute while the card runs.  The
   last KKT matrix that (e) hands B1' is then held against the plain
   version as in phase 3, with ``torch.linalg.cholesky`` as its yardstick;
9. last options: the discrete loop's last options on the card, each run
   held against the port's CPU run of the same configuration (status,
   iteration and accepted-step counts equal, x to 1e-6 when Optimal), with
   its launches, launches per iteration and ms per iteration beside those
   of phase 4, 5 or 6 for the same problem: (a) ``report_rcond`` on the
   pendulum at N = 128 (B1' only) and N = 256 (B3' only), rcond equal to
   the CPU run's to 1e-8 relative and the launches of phase 4 (the
   estimate adds solves, not factors); (b) ``collect_path`` at N = 128, the
   path's accepted + 1 columns and model times equal to the CPU run's to
   1e-6; (c) the Symmetric step solver with MINRES at N = 128 and with
   GMRES at N = 32 (no kernel); (d) ``BatchedSolver`` on 16384 lanes of
   Rosenbrock under the Optimizing and the BoxReduced controls, every lane
   Optimal, with the inner loops' host reads per outer iteration; (e)
   phase 5's fleet with ``report_rcond`` (B2' only), rcond of lanes 0-7
   equal to the CPU run's to 1e-8 relative; (f) BoxReduced on the boxed
   Laplacian QP at n = 150 (the reduced Hessian through the plain LU, no
   kernel).  The CPU references run in worker processes while the card
   runs;
10. continuous: the continuous engine (``pygradflow_torch.integration``)
   on the card, no kernel, each run held against the port's CPU run of the
   same configuration (worker processes meanwhile): status, segments,
   integration steps and Newton steps equal and x within 1e-8, or, where
   the roundings part the counts, Optimal and x within 1e-6 (listed at the
   end), and counts equal to those of the JAX package's run that takes
   the same trajectory (``JAX_INTEG``); with each run's wall, ms per step
   or work unit and host reads: (a) the host engine on HS71 and Tame under
   TR-BDF2 and SDIRK4; (b) implicit Euler on the host engine for three
   small problems and on the flat engine for HS71 (run last, its CPU
   reference being the longest); (c) HS71 under SDIRK4 on the device and
   flat engines; (d) ``BatchedIntegrationSolver`` on 1024, then 64,
   perturbed HS71 starts (every lane Optimal, lanes 0-7 against the CPU's
   single flat solves and JAX's lanes), with the CUDA-event ms of one work
   unit's fast and full graphs.  The CPU runs start with this phase, in 5
   worker processes.  ``python3 chip_smoke.py --only 10`` runs this phase
   alone;
11. precision: single precision, the mixed sweep, checkpoint and resume,
   the display, derivative checks and multistart on the card, each run
   held against the port's CPU run of the same configuration (3 worker
   processes started with the phase): status, counts and x (1e-3 in f32,
   1e-6 in f64), or, where f32 rounding parts a knife-edge lane's counts,
   both Optimal and x within that bound (listed as parted); (a)
   ``bench.py``'s f32 headline (16384 Rosenbrock lanes, every lane Optimal,
   |x - 1| < 1e-2) and (b) its Mixed (``MixedPrecisionSolver``, |x - 1| <
   1e-4), solves/s from a warm-up and the minimum of 5 beside the f64
   headline timed alike; (c) ``bench_hs.py``'s ``f32_4096_tol4`` and
   ``mixed_16384`` on HS71 (success 1.0); (a)-(c) also against the JAX
   package's counts; (d) the pendulum at N = 128 in f32 (B1' only), whose
   last f32 KKT matrix is then held against the plain version as in phase
   3; (e) ``MixedPrecisionSolver`` on phase 5's fleet (B2' in both stages);
   (f) the pendulum at N = 128 cut at 8 iterations with a checkpoint and
   resumed, bit for bit equal to the uninterrupted solve; (g) HS71 with the
   display (a row per iteration, the counts and x of the run without it)
   and ``DerivCheck.CheckAll``, and a wrong gradient raising
   ``DerivError``; (h) ``multistart_solve`` on 1024 starts of a four-well
   problem (best lane and objective); (i) ``IntegrationSolver`` in f32 on
   Tame.  ``python3 chip_smoke.py --only 11`` runs the build and this
   phase alone;
12. multi-device: the multi-device frontends and the runners on the card,
   every mesh a repetition of the one card: (a) ``ShardedSolver`` on phase
   6's 16384 Rosenbrock lanes over 1 and 4 shards, every lane bit for bit
   ``BatchedSolver``'s with and without compaction, solves/s beside it;
   (a2) phase 5's fleet over 2 shards (B2' only), status and counts of
   phase 5's lanes and x within 1e-6, its bits reported (batched cuBLAS
   products choose their algorithms by batch count); (b)
   ``DistributedSolver`` with 2 ranks sharing the card over gloo and 1 rank
   under NCCL, each rank's full result bit for bit (a)'s; (c)
   ``distributed_schur_solve`` at 512 blocks of 8 and m = 1024 over 4
   shards within rtol 1e-9, atol 1e-10 of a dense f64 solve; (d)
   ``ShardedIntegrationSolver`` on phase 10's 1024 lanes over 4 shards, bit
   for bit phase 10's; (e) the 80 HS specs through ``hs_runner --parallel
   4`` on the card (hs104 and hs106, 10,000 iterations each, dispatched
   first: ``tools/hs_long_first.py``) against the port's CPU sweep (in
   sequence), both
   started in the background after phase 3 (a child takes seconds to reach the card, and
   hs104 and hs106 run 10,000 iterations each): statuses, counts and the
   objective within 1e-6, where a run of at least 1,000 iterations or a
   spec that rounding parts between the packages may part in its counts
   (listed); (f) ``QPRunner`` and ``MPSRunner`` on an inline MPS file,
   the native reader equal to the Python one, each row against the CPU
   run.  ``python3 chip_smoke.py --only 12`` runs the build and this phase
   alone.
13. surface (run before phase 12, beside its HS sweeps): (a) the five
   examples of ``docs/torch`` through their ``main(device="cuda")`` at the
   JAX examples' sizes, each held to the port's CPU run of the same
   example (worker processes started with the phase): equal status and
   counts, x within 1e-6, their launches recorded; (b)
   ``Solver.perform_iteration`` on Rosenbrock at ``Params()`` and on the
   pendulum at N = 128 on PallasLDLT (B1' must launch), (x, y, d) within
   1e-10 of the CPU; (c) the parity harness (``tools/torch_parity_check.py``)
   on the card: the pendulum at N = 128 (B1') and N = 256 (B3') here, and
   in a process of its own, started with phase 12's HS sweeps after phase
   3, the HS specs and option cases whose JAX run took at most 200
   iterations, every row against
   ``tools/torch_parity_jax.json`` under the harness's limits and its
   expected partings.  ``python3 chip_smoke.py --only 13`` runs the build
   and this phase alone.
14. loop (run after phase 3, before the background processes start): the
   solve loop on the device.  Each configuration of ``LOOP_RUNS``
   (Rosenbrock and HS71 at ``Params()``, HS71 on the LDLT and PallasLDLT
   tiers, the pendulum at N = 128 (B1') and N = 256 (B3'), phase 5's
   fleet (B2'), the B=16384 headline, HS71 in f32,
   ``MixedPrecisionSolver``'s two stages, and HS71 under each Newton type,
   step control and penalty whose iteration reads no host) solves through
   the graphed chunk (a CUDA graph per solver and width, replayed
   ``jit_chunk`` times per host read) and through the eager chunk, in
   turns: the two results bit for bit, the graphed solve one host read per
   chunk and no capture when warm; ms per iteration, captures and their
   seconds, the ldlt wrappers' launches (counted on the device inside a
   graph, once per body run), and for six
   of them the device's idle share and kernels per iteration over a warm
   solve (``torch.profiler``); the headline's solves/s per route, the
   minimum of 5 after a warm-up, with its spread.  At the end of the
   script a problem that reads the host must fail its card solve, naming
   its objective; HS71 solved as a graph before and after it, and through
   ``--debug_nans``'s checked problem (the eager loop), gives the same
   bits.  ``python3 chip_smoke.py --only 14`` runs the build and
   this phase alone.

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
# (n, m) of each saddle; the first of each kernel has the pendulum's shape,
# the last fits one panel (n <= NB), where the whole factor is bitwise
KERNEL_SIZES = {"rl": [(386, 258), (960, 320), (60, 40)], "ll": [(770, 514), (1536, 512), (30, 20)]}
MAIN_PATH_SIZE = {"rl": 644, "ll": 1284}  # KKT of the pendulum at N=128 / N=256
# (B, n, m) of each batched stack; the first is the fleet's (N=64, KKT 324)
BATCHED_SIZES = [(128, 194, 130), (8, 60, 20), (8, 60, 40)]
# the card's peaks for the bound (NVIDIA H100 SXM data sheet): f32 without
# tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNELS = {
    "rl": ("ldlt_factor_rl", "pygradflow_tpu/linalg/pallas_ldlt.py:112"),
    "ll": ("ldlt_factor_ll", "pygradflow_tpu/linalg/pallas_ldlt_hbm.py:162"),
    "rl_batched": ("ldlt_factor_rl_batched", "pygradflow_tpu/linalg/pallas_ldlt.py:116"),
}
FLEET_N, FLEET_B, CPU_LANES = 64, 128, 8
HEADLINE_B = 16384
# ms per iteration and launches of phases 4-6, which phase 9 prints beside
# its own for the same problem
PHASE_MS = {}
SLICE_LAUNCHES = {}


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


def bound(shape):
    """Least time (ms) the card could take to factor a matrix or stack of
    ``shape``: the larger of n^3 / 3 FLOPs per matrix at the f32 peak and
    the input read once plus the factor written once at the memory rate."""
    batch = 1
    for d in shape[:-2]:
        batch *= d
    n = shape[-1]
    flop_ms = 1e3 * batch * n**3 / 3 / PEAK_F32_FLOPS
    byte_ms = 1e3 * batch * 2 * 4 * n * n / PEAK_BYTES
    return (flop_ms, "operations") if flop_ms >= byte_ms else (byte_ms, "bytes")


def update_bound_us(key, n, batch=1):
    """Least time (us) the card could take for one factor's update
    products: per launch the larger of its FLOPs at the f32 peak and its
    bytes (inputs read once, outputs written once) at the memory rate,
    summed over the launches.  "ll": P -= L_{:,<b} (L_{b,<b} D)^T on the
    n_pad - b rows of each panel b; "rl", "rl_batched": the trailing
    update on the 128-wide lower blocks it computes."""
    total = 0.0
    if key == "ll":
        nb = 64
        n_pad = -(-n // nb) * nb
        for b in range(nb, n_pad, nb):
            rows = n_pad - b
            flops = 2 * rows * nb * b
            nbytes = 4 * (rows * b + b + 2 * rows * nb)  # L rows, d, P in and out
            total += max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    else:
        nb = 128
        n_pad = -(-n // nb) * nb
        for base in range(0, n_pad - nb, nb):
            m = (n_pad - base) // nb - 1
            blocks = m * (m + 1) // 2
            flops = batch * blocks * 2 * nb**3
            nbytes = batch * 4 * (m * nb * nb + nb + 2 * blocks * nb * nb)  # L panel, d, tiles in and out
            total += max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    return 1e6 * total


def device_phase():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    card = out[0].strip()
    print(card, flush=True)
    return card


def ptxas_report(log):
    """{kernel: (registers, spill bytes)} from ``nvcc -Xptxas -v`` output."""
    import re

    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            report[name] = [None, int(m.group(1)) + int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in report:
            report[name][0] = int(m.group(1))
    return report


# every instance of the panel-factor and update kernels, as ptxas names them
BUILT_KERNELS = {
    "diag_block_kernel<64>", "diag_block_kernel<128>", "panel_rows_kernel<64>", "panel_rows_kernel<128>",
    "trailing_update_kernel<128, 64>", "trailing_update_kernel<128, 32>", "left_update_kernel<64>",
}


def build_phase():
    """Builds the kernels and prints what ptxas says of the panel-factor and
    update kernels; a spill there fails the run."""
    import re

    from pygradflow_torch import build

    build.load_library()
    print(f"build: {build.BUILD_SECONDS:.1f} s ({build.library_path().parent.name})", flush=True)
    report = ptxas_report((build.library_path().parent / "build.log").read_text())
    found = {}
    for mangled, regs_spill in report.items():
        m = re.search(r"(diag_block|panel_rows|trailing_update|left_update)_kernel(\w*)", mangled)
        if m:
            args = ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
            found[f"{m.group(1)}_kernel<{args}>"] = regs_spill
    if set(found) != BUILT_KERNELS:
        fail(f"build: expected {sorted(BUILT_KERNELS)} in the ptxas report, got {sorted(found)}")
    for name, (regs, spill) in sorted(found.items()):
        print(f"build: {name} {regs} registers, {spill} spill bytes", flush=True)
        if spill:
            fail(f"build: {name} spills {spill} bytes")


def path_matrices(device):
    """The f32 matrices that phase 7 gives the kernels, built by the port's
    own Schur step from ``PendulumControlInterleaved`` at its start point
    (``lamb_init``, ``rho``, y = 0, no active bound), with a stand-in dual
    tier that keeps each matrix instead of factoring it.  Every one is
    negative definite.  Returns ``{"rl": [(label, matrix, negative
    eigenvalues)], "rl_batched": [...], "two_level": S}``; the two-level
    diagonal blocks are those of B1's plain version; "ll" holds the dense
    dual S at N = 768 (1538 rows), which routes to B3'."""
    import numpy as np
    import torch
    from torch.func import vmap

    from pygradflow_torch import Params
    from pygradflow_torch.linalg import LinearSolver
    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.linalg.two_level_ldlt import _super_block_factor
    from pygradflow_torch.runners.control import PendulumControlInterleaved
    from pygradflow_torch.step.schur import schur_def

    params = Params()
    keep = LinearSolver(lambda mat: mat, None, None, None, "pallas_ldlt")

    class Func:
        lamb = params.lamb_init

    def dual(N, dual_block=None, batch=None):
        """The dense dual S, or with ``dual_block`` the root that BCR hands
        the tier; for ``batch`` lanes from the fleet's start points."""
        problem = PendulumControlInterleaved(N=N)
        x0 = problem.x0_trajectory()
        if batch:
            rng = np.random.default_rng(0)
            x0 = x0[None, :] + 0.02 * rng.standard_normal((batch, problem.num_vars))
        x = torch.tensor(x0, device=device)
        y = x.new_zeros(x.shape[:-1] + (problem.num_cons,))
        hess, jac = problem.lag_hess, problem.cons_jac
        if batch:
            hess, jac = vmap(hess), vmap(jac)
        active = torch.zeros(x.shape, dtype=torch.bool, device=device)
        fact = schur_def(keep, 3, dual_block).factor(Func, hess(x, y), jac(x), active, params.rho).fact
        if dual_block is None:
            return fact.s_fact
        if fact.s_fact.root_kind != "lin":
            fail(f"N={N}: the BCR root did not go to the PallasLDLT tier")
        return fact.s_fact.root_fact

    s256, s1024 = dual(256), dual(1024)
    blocks = []

    def plain_block(block):
        blocks.append(block.clone())
        return lk.ldlt_factor_rl_ref(block)

    _super_block_factor(s1024, 1025, plain_block)
    return {
        "rl": [
            ("dense dual S, N=256", s256, 514),
            ("BCR root, N=1024", dual(1024, 2), 512),
            ("two-level diagonal block 1, N=1024", blocks[0], 1025),
            ("two-level diagonal block 2, N=1024", blocks[1], 1025),
        ],
        "ll": [("dense dual S, N=768", dual(768), 1538)],
        "rl_batched": [("BCR roots of the fleet, N=100", dual(100, 2, FLEET_B), 256)],
        "two_level": s1024,
    }


def _factor_check(label, kernel, plain, a64, neg_expected, rng, card, block=None, library=None):
    """``kernel`` against ``plain`` on the f32 cast of ``a64`` (a matrix or a
    stack): the same bits from a second call, the lower triangles to TOL,
    the first ``block`` columns bit for bit (the whole factor when n <=
    block), the inertia, the refined residual; times the kernel, the plain
    version and ``library`` (one PyTorch call of the same factor, up to
    scale, or None); prints one line and returns a record for the
    summary."""
    import torch

    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.linalg.ldlt import ldlt_num_neg_eigvals
    from pygradflow_torch.linalg.two_level_ldlt import guard_factor

    a32 = a64.to(torch.float32).contiguous()
    packed = kernel(a32)
    again = kernel(a32)
    ref = plain(a32)
    torch.cuda.synchronize()
    if not torch.equal(packed, again):
        fail(f"{label}: two calls on the same input gave different bits")
    lo, lo_ref = torch.tril(packed), torch.tril(ref)
    err = (lo - lo_ref).abs().max().item()
    if not torch.allclose(lo, lo_ref, rtol=TOL, atol=TOL):
        fail(f"{label}: tril differs from the plain version (max abs {err:.3e})")
    n = a64.shape[-1]
    if block is not None and not torch.equal(packed[..., :block], ref[..., :block]):
        fail(f"{label}: the first {min(n, block)} of {n} columns not bit for bit equal to the plain version")
    neg = ldlt_num_neg_eigvals(packed).reshape(-1).tolist()
    neg_ref = ldlt_num_neg_eigvals(ref).reshape(-1).tolist()
    if not neg == neg_ref == [neg_expected] * len(neg):
        fail(f"{label}: inertia {sorted(set(neg))} vs plain {sorted(set(neg_ref))}, expected {neg_expected}")
    b = torch.tensor(rng.standard_normal(a64.shape[:-1]), device=a64.device)
    x = lk.refine_solve(guard_factor(packed, a64), a64, b)
    res = ((a64 @ x[..., None])[..., 0] - b).abs().max().item()
    if not res <= RES_TOL:
        fail(f"{label}: refined residual {res:.3e} > {RES_TOL}")
    ms = cuda_ms(lambda: kernel(a32))
    plain_ms = cuda_ms(lambda: plain(a32))
    library_ms = None if library is None else cuda_ms(lambda: library(a32))
    bound_ms, bound_by = bound(tuple(a64.shape))
    bits = "" if block is None else f" bitwise=first {min(n, block)} of {n} columns"
    lib = "" if library_ms is None else f" cholesky_ms={library_ms:.4f}"
    print(
        f"{label}: max_abs_err={err:.3e}{bits} deterministic inertia={neg_expected} refined_res={res:.3e} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f}{lib} bound_ms={bound_ms:.6f} ({bound_by}) [{card}]",
        flush=True,
    )
    return dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_us=1e3 * bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )


def _cholesky_of_negated(a32):
    """The library yardstick for a negative definite S: cuSOLVER's f32
    Cholesky of -S, the same factor up to scale (L_chol = L diag(sqrt(-D)));
    timed only here, never called by the port."""
    import torch

    return torch.linalg.cholesky(-a32)


def _zero_pivot(a, k, lane=None):
    """``a`` with row and column k zeroed (in one lane of a stack)."""
    a = a.copy()
    at = a if lane is None else a[lane]
    at[k, :] = 0.0
    at[:, k] = 0.0
    return a


def kernel_phase(card, path):
    """Each kernel against its plain version on the card, on saddle matrices
    and on the matrices ``path`` of phase 7; returns per-kernel records at
    the main path's sizes, each with a list of the path's cases."""
    import numpy as np
    import torch

    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.linalg.two_level_ldlt import guard_factor

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    records = {}
    for key, sizes in KERNEL_SIZES.items():
        name, _ = KERNELS[key]
        kernel = getattr(lk, name)
        plain = getattr(lk, name + "_ref")
        block = lk.LL_BLOCK if key == "ll" else lk.RL_BLOCK
        cases = []

        def inputs():
            for n, m in sizes:
                yield "saddle", torch.tensor(saddle(rng, n, m), device=dev), m, None
            for label, mat, neg in path.get(key, ()):
                yield label, mat.to(torch.float64), neg, _cholesky_of_negated

        for label, a64, neg, library in inputs():
            n = a64.shape[-1]
            rec = _factor_check(
                f"kernel {name} n={n} ({label})", kernel, plain, a64, neg, rng, card, block, library
            )
            if n == MAIN_PATH_SIZE[key] and label == "saddle":
                records[key] = rec
            if library is not None:
                cases.append(dict(case=label, shape=list(a64.shape), **rec))
        records[key]["cases"] = cases

        # a zero pivot inside a later panel, at a panel's last column and at
        # the next panel's first poisons the factor with NaN
        base = saddle(rng, *sizes[0])
        for k in (200, block - 1, block):
            a32 = torch.tensor(_zero_pivot(base, k), dtype=torch.float32, device=dev)
            for label, packed in (("kernel", kernel(a32)), ("plain", plain(a32))):
                if not torch.isnan(torch.diagonal(packed)[k:]).any():
                    fail(f"{name}: zero pivot at {k} left no NaN in the {label} factor")
                if not torch.isnan(guard_factor(packed, a32)).all():
                    fail(f"{name}: guard did not poison the {label} factor")
            print(f"kernel {name}: zero pivot at {k} gives NaN", flush=True)
    return records


def two_level_phase(card, path):
    """The two-level factor of the dense dual S at N=1024 (2 x 1025 through
    B1') against the same super-blocks through B1's plain version."""
    import numpy as np
    import torch

    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.linalg.two_level_ldlt import _super_block_factor, ldlt_factor_two_level

    s = path["two_level"]
    _factor_check(
        f"two-level factor n={s.shape[-1]} (dense dual S, N=1024)",
        ldlt_factor_two_level,
        lambda a: _super_block_factor(a, 1025, lk.ldlt_factor_rl_ref),
        s.to(torch.float64),
        s.shape[-1],
        np.random.default_rng(SEED),
        card,
    )


def batched_kernel_phase(card, path):
    """The batched kernel against the right-looking kernel on each instance
    and against its plain version, on saddle stacks and on the stack
    ``path`` of phase 7; returns its record at the fleet's shape."""
    import numpy as np
    import torch

    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.linalg.two_level_ldlt import guard_factor

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    record, cases = None, []

    def inputs():
        for batch, n, m in BATCHED_SIZES:
            stack = np.stack([saddle(rng, n, m) for _ in range(batch)])
            yield "saddle", torch.tensor(stack, device=dev), m, None
        for label, mat, neg in path["rl_batched"]:
            yield label, mat.to(torch.float64), neg, _cholesky_of_negated

    for label, a64, neg, library in inputs():
        batch, n = a64.shape[0], a64.shape[-1]
        tag = f"kernel ldlt_factor_rl_batched B={batch} n={n} ({label})"
        a32 = a64.to(torch.float32).contiguous()
        packed = lk.ldlt_factor_rl_batched(a32)
        singles = [lk.ldlt_factor_rl(a32[i]) for i in range(batch)]
        torch.cuda.synchronize()
        unequal = [i for i in range(batch) if not torch.equal(packed[i], singles[i])]
        if unequal:
            fail(f"{tag}: lanes {unequal[:8]} differ from ldlt_factor_rl")
        rec = _factor_check(
            tag, lk.ldlt_factor_rl_batched, lk.ldlt_factor_rl_batched_ref, a64, neg, rng, card,
            lk.RL_BLOCK, library,
        )
        loop_ms = cuda_ms(lambda: [lk.ldlt_factor_rl(a32[i]) for i in range(batch)])
        print(f"{tag}: bitwise equal to ldlt_factor_rl on every lane, rl_loop_ms={loop_ms:.4f} [{card}]", flush=True)
        if record is None:
            record = rec
        if library is not None:
            cases.append(dict(case=label, shape=list(a64.shape), **rec))
    record["cases"] = cases

    # a zero pivot in one lane poisons that lane only, inside a panel and at
    # either side of a panel edge
    for (batch, n, m), k in ((BATCHED_SIZES[1], 40), ((8, 194, 130), 127), ((8, 194, 130), 128)):
        lane = 3
        a = _zero_pivot(np.stack([saddle(rng, n, m) for _ in range(batch)]), k, lane)
        a32 = torch.tensor(a, dtype=torch.float32, device=dev)
        for label, packed in (("kernel", lk.ldlt_factor_rl_batched(a32)), ("plain", lk.ldlt_factor_rl_batched_ref(a32))):
            guarded = guard_factor(packed, a32)
            others = [i for i in range(batch) if i != lane]
            if not torch.isnan(guarded[lane]).all() or not torch.isfinite(torch.tril(guarded[others])).all():
                fail(f"rl_batched: zero pivot at {k} in lane {lane} did not poison that lane alone ({label})")
        print(f"kernel ldlt_factor_rl_batched: zero pivot at {k} in lane {lane} gives NaN in that lane only", flush=True)
    return record


def split_phase(card):
    """Device time of each CUDA kernel within one factor at the main path's
    sizes (644 through B1', 1284 through B3', the fleet's (128, 324)
    through B2'), from torch.profiler over 5 factors after a warm-up, and
    each panel and update kernel's time per launch (per panel, in order)
    within the first of them."""
    import re

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pygradflow_torch.linalg import ldlt_kernels as lk

    def kernel_name(key):
        m = re.search(r"(\w+_kernel)(<[\d, ]+>)?", key)
        return m.group(1) + (m.group(2) or "") if m else key

    rng = np.random.default_rng(SEED)
    batch, bn, bm = BATCHED_SIZES[0]
    cases = (
        ("rl", saddle(rng, *KERNEL_SIZES["rl"][0])),
        ("ll", saddle(rng, *KERNEL_SIZES["ll"][0])),
        ("rl_batched", np.stack([saddle(rng, bn, bm) for _ in range(batch)])),
    )
    runs = 5
    for key, a in cases:
        name, _ = KERNELS[key]
        fn = getattr(lk, name)
        a32 = torch.tensor(a, dtype=torch.float32, device="cuda")
        shape = "x".join(map(str, a.shape[:-1]))
        fn(a32)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn(a32)
            torch.cuda.synchronize()
        parts = [
            f"{kernel_name(ev.key)} {ev.device_time_total / runs:.1f} us ({ev.count // runs} launches)"
            for ev in prof.key_averages()
            if ev.device_time_total > 0
        ]
        if not parts:
            fail(f"split {name}: the profiler saw no device time")
        lead, n = a.shape[:-2], a.shape[-1]
        bound_us = update_bound_us(key, n, lead[0] if lead else 1)
        print(f"split {name} {shape}, per factor: {'; '.join(parts)}; update bound_us={bound_us:.2f} [{card}]", flush=True)
        kernels = sorted(
            (ev for ev in prof.events() if ev.device_type == DeviceType.CUDA), key=lambda ev: ev.time_range.start
        )
        per_factor = len(kernels) // runs
        for kind in ("diag_block_kernel", "panel_rows_kernel", "trailing_update_kernel", "left_update_kernel"):
            times = [
                f"{ev.device_time_total:.1f}{kernel_name(ev.name)[len(kind):]}"
                for ev in kernels[:per_factor]
                if kind in ev.name
            ]
            if times:
                print(f"split {name} {shape}, {kind} us per panel in order: {' '.join(times)} [{card}]", flush=True)


def _solve_once(problem, params, device, x0, batched=False):
    """One solve on ``device`` with the launch counters set to 0 before it;
    returns the result, the launches it made and its wall seconds."""
    import torch

    from pygradflow_torch import Solver
    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.parallel import BatchedSolver

    x0 = torch.tensor(x0, device=device)
    for key in lk.LAUNCHES:
        lk.LAUNCHES[key] = 0
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = BatchedSolver(problem, params, device=device) if batched else Solver(problem, params, device=device)
    res = solver.solve(x0)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, dict(lk.LAUNCHES), time.perf_counter() - t0


def _hold(label, res, ref, ref_label, require_optimal=True):
    """A single solve against the run named ``ref_label``: equal status
    (Optimal, unless ``require_optimal`` is false) and counts, x finite and
    of the reference's shape, and within X_TOL when both are Optimal;
    returns |x - x_ref|."""
    import numpy as np

    from pygradflow_torch import SolverStatus

    optimal = res.status == SolverStatus.Optimal
    if require_optimal and not optimal:
        fail(f"{label}: status {res.status.name}, {ref_label} {ref.status.name}")
    ours = (res.status.name, res.iterations, res.num_accepted_steps)
    theirs = (ref.status.name, ref.iterations, ref.num_accepted_steps)
    if ours != theirs:
        fail(f"{label}: {ours}, {ref_label} {theirs}")
    x, x_ref = res.x.cpu().numpy(), ref.x.cpu().numpy()
    if not np.isfinite(x).all() or x.shape != x_ref.shape:
        fail(f"{label}: solution not finite or of the wrong shape")
    dx = np.abs(x - x_ref).max()
    if optimal and not dx <= X_TOL:
        fail(f"{label}: x differs from {ref_label} by {dx:.3e}")
    return dx


def _expect_launches(label, used, only):
    """``only`` the kernels named were launched, each at least once."""
    if any((used[k] == 0) == (k in only) for k in used):
        fail(f"{label}: launches {used}, expected only {sorted(only) or 'none'}")


def slice_phase(card):
    """The pendulum at N=128 and N=256 on the card against the port's CPU run;
    returns the launch counts of the main path's run."""
    from pygradflow_torch import LinearSolverType, Params
    from pygradflow_torch.runners.control import PendulumControl

    params = Params(
        linear_solver_type=LinearSolverType.PallasLDLT,
        iteration_limit=3000,
        validate_input=False,
    )
    expect = {128: "rl", 256: "ll"}
    totals = dict.fromkeys(("rl", "ll", "rl_batched"), 0)
    for N, key in expect.items():
        problem = PendulumControl(N=N)
        x0 = problem.x0_trajectory()
        cpu, _, _ = _solve_once(problem, params, "cpu", x0)
        for run in ("first", "repeat"):
            res, used, wall = _solve_once(problem, params, "cuda", x0)
            dx = _hold(f"N={N}", res, cpu, "the cpu run")
            _expect_launches(f"N={N}", used, {key})
            print(
                f"slice N={N} ({run}): {res.status.name} {res.iterations}/"
                f"{res.num_accepted_steps} launches={used} |x-x_cpu|={dx:.3e} "
                f"wall={wall:.3f} s ms/iter={1e3 * wall / res.iterations:.2f} [{card}]",
                flush=True,
            )
            for k in totals:
                totals[k] += used[k]
            PHASE_MS[("pendulum", N)] = 1e3 * wall / res.iterations
            SLICE_LAUNCHES[N] = used[key]
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
        PHASE_MS[("fleet", FLEET_N)] = 1e3 * wall / iters
    REFERENCES["fleet"] = res
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
        PHASE_MS["headline"] = 1e3 * wall / int(res.iterations.max())
        REFERENCES["headline"], REFERENCES["headline wall"] = res, wall

    # compaction only permutes lanes; batched BLAS may pick other algorithms
    # at other widths, so x is held to X_TOL and its bitwise equality reported
    plain = BatchedSolver(Rosenbrock(), params, device="cuda", compact=False).solve(x0_dev)
    REFERENCES["headline plain"] = plain
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


def control_phase(card):
    """Phase 7: the Schur tiers on the interleaved pendulum (BASELINE
    config #4), each run held against the run named beside it; returns the
    launches of the card runs through the mixed-precision tier."""
    import numpy as np
    import torch

    from pygradflow_torch import LinearSolverType, Params, SolverStatus, StepSolverType
    from pygradflow_torch.runners.control import PendulumControlInterleaved

    schur = dict(step_solver_type=StepSolverType.Schur, schur_block_size=3, iteration_limit=3000, validate_input=False)
    staged = dict(schur, schur_dual_block_size=2, matrix_free=True)
    pallas = dict(linear_solver_type=LinearSolverType.PallasLDLT)
    totals = dict.fromkeys(("rl", "ll", "rl_batched"), 0)

    def single(label, N, kwargs, only, refs):
        """A card solve; ``refs`` maps a label to (device, kwargs) of the runs
        it is held against (a card reference must launch no kernel)."""
        problem = PendulumControlInterleaved(N=N)
        x0 = problem.x0_trajectory()
        res, used, wall = _solve_once(problem, Params(**kwargs), "cuda", x0)
        _expect_launches(label, used, only)
        held = []
        for ref_label, (device, ref_kwargs) in refs.items():
            ref, ref_used, _ = _solve_once(problem, Params(**ref_kwargs), device, x0)
            _expect_launches(ref_label, ref_used, set())
            held.append(f"|x-x_{ref_label}|={_hold(label, res, ref, ref_label):.3e}")
        print(
            f"control {label} N={N}: {res.status.name} {res.iterations}/{res.num_accepted_steps} "
            f"launches={used} {' '.join(held)} wall={wall:.3f} s "
            f"ms/iter={1e3 * wall / res.iterations:.2f} [{card}]",
            flush=True,
        )
        for k in totals:
            totals[k] += used[k]

    # (a) the dense dual Schur complement, 514 x 514, through B1'
    single("(a) dense dual PallasLDLT", 256, dict(schur, **pallas), {"rl"}, {"cpu": ("cpu", dict(schur, **pallas))})
    # (b) matrix-free staged, BCR down to a 512-row root through B1'
    single(
        "(b) Schur+MF PallasLDLT", 1024, dict(staged, **pallas), {"rl"},
        {"cuda_f64": ("cuda", staged), "cpu": ("cpu", dict(staged, **pallas))},
    )
    single("(b) Schur+MF PallasLDLT", 4096, dict(staged, **pallas), {"rl"}, {"cuda_f64": ("cuda", staged)})
    # (c) the dense dual at N=1024 (2050 rows): the two-level factor, 2 x 1025 through B1'
    single("(c) dense dual PallasLDLT", 1024, dict(schur, **pallas), {"rl"}, {"cuda_f64": ("cuda", schur)})

    # (d), (e) the MPC fleet: root (B, 512, 512) at N=256 takes the panel
    # factor as JAX routes it; root (B, 256, 256) at N=100 the batched kernel
    params = Params(**staged, **pallas)
    for label, N, only in (("(d)", 256, set()), ("(e)", 100, {"rl_batched"})):
        problem = PendulumControlInterleaved(N=N)
        rng = np.random.default_rng(0)
        x0 = problem.x0_trajectory()[None, :] + 0.02 * rng.standard_normal((FLEET_B, problem.num_vars))
        cpu, _, _ = _solve_once(problem, params, "cpu", x0[:CPU_LANES], batched=True)
        res, used, wall = _solve_once(problem, params, "cuda", x0, batched=True)
        _expect_launches(f"fleet {label}", used, only)
        dx = _check_lanes(f"fleet {label} N={N}", res, cpu, slice(0, CPU_LANES))
        if not torch.isfinite(res.x).all() or tuple(res.x.shape) != (FLEET_B, problem.num_vars):
            fail(f"fleet {label} N={N}: solutions not finite or of the wrong shape")
        optimal = int((res.status == int(SolverStatus.Optimal)).sum())
        iters = int(res.iterations.max())
        print(
            f"control {label} fleet Schur+MF PallasLDLT N={N} B={FLEET_B}: {optimal}/{FLEET_B} "
            f"Optimal, lockstep iterations {iters}, lanes 0-{CPU_LANES - 1} {res.iterations[0].item()}/"
            f"{res.accepted_steps[0].item()} launches={used} |x-x_cpu|={dx:.3e} wall={wall:.3f} s "
            f"solves/s={FLEET_B / wall:.1f} ms/iter={1e3 * wall / iters:.2f} [{card}]",
            flush=True,
        )
        for k in totals:
            totals[k] += used[k]
    print(f"control launches: {totals}", flush=True)
    return totals


def boxed_qp(n):
    """The boxed Laplacian QP of ``tests/test_qp.py:23-37`` at size ``n``
    (m = 0) and its start point ``max(lb, 0)``."""
    import numpy as np

    from pygradflow_torch.problem import QuadraticProblem

    h = 1.0 / n
    e = np.ones(n)
    H = (np.diag(2 * e) - np.diag(e[:-1], 1) - np.diag(e[:-1], -1)) / h**2
    lb = np.linspace(0, -0.01, n + 2)[1:-1].copy()
    lb[n // 4] = 0.0
    lb[3 * n // 4] = 0.0
    lb[n // 2] = 0.0
    return QuadraticProblem(H, e, var_lb=lb, var_ub=np.full(n, np.inf)), np.maximum(lb, 0.0)


OPTIONS_N, OPTIONS_LL_N, OPTIONS_QP_N = 128, 256, 1000
OPTIONS_GLOBALIZED_FLEET_IT = 20


OPTIONS_RUNS = [
    "(a) Full", "(a) ActiveSet", "(a) Globalized", "(b) ParetoDecrease", "(b) LagrangianFilter",
    "(b) ResiduumRatio", "(b) Exact", "(b) GradJac", "(c) Full", "(d) ActiveSet+LagrangianFilter", "(d) Exact",
    "(d) Globalized", "(e) QP",
]
"""Phase 8's runs in the card's order; the CPU references start longest
first, the QP's."""


def _options_config(name):
    """Problem, params, start points and whether it is a batch, of the phase
    8 run ``name``; the card and the CPU reference build it alike."""
    import numpy as np

    from pygradflow_torch import LinearSolverType, Params
    from pygradflow_torch.runners.control import PendulumControl

    pallas = dict(linear_solver_type=LinearSolverType.PallasLDLT, iteration_limit=3000, validate_input=False)
    single = {
        "(a) Full": dict(newton_type="Full"),
        "(a) ActiveSet": dict(newton_type="ActiveSet"),
        "(a) Globalized": dict(newton_type="Globalized", iteration_limit=50),
        "(b) ParetoDecrease": dict(penalty_update="ParetoDecrease"),
        "(b) LagrangianFilter": dict(penalty_update="LagrangianFilter"),
        "(b) ResiduumRatio": dict(step_control_type="ResiduumRatio"),
        "(b) Exact": dict(step_control_type="Exact"),
    }
    if name in single or name == "(b) GradJac":
        problem = PendulumControl(N=OPTIONS_N)
        x0 = problem.x0_trajectory()
        kwargs = single.get(name) or dict(scaling_type="GradJac", scaling_primal=x0)
        return problem, Params(**dict(pallas, **kwargs)), x0, False
    if name == "(c) Full":
        problem = PendulumControl(N=OPTIONS_LL_N)
        return problem, Params(**dict(pallas, newton_type="Full")), problem.x0_trajectory(), False
    if name.startswith("(d)"):
        # the fleet in lockstep: ActiveSet Newton with the LagrangianFilter;
        # the Exact control and Globalized Newton, whose lane forms run their
        # inner loops to the limit with no host read
        fleets = {
            "(d) ActiveSet+LagrangianFilter": dict(newton_type="ActiveSet", penalty_update="LagrangianFilter"),
            "(d) Exact": dict(step_control_type="Exact"),
            "(d) Globalized": dict(newton_type="Globalized", iteration_limit=OPTIONS_GLOBALIZED_FLEET_IT),
        }
        problem = PendulumControl(N=FLEET_N)
        rng = np.random.default_rng(0)
        x0 = problem.x0_trajectory()[None, :] + 0.02 * rng.standard_normal((FLEET_B, problem.num_vars))
        return problem, Params(**dict(pallas, **fleets[name])), x0, True
    assert name == "(e) QP"
    problem, x0 = boxed_qp(OPTIONS_QP_N)
    params = Params(linear_solver_type=LinearSolverType.PallasLDLT, lamb_init=1e-12, iteration_limit=1000,
                    newton_type="ActiveSet")
    return problem, params, x0, False


def options_phase(card, workers=3):
    """Phase 8: the options of the discrete loop on the card, each run held
    against the port's CPU run, which worker processes compute while the
    card runs (status and counts equal, x to X_TOL when Optimal) with only
    the kernel named launched: (a) Newton types and (b) controls, penalties
    and GradJac scaling on the pendulum at N = 128 (B1'), (c) Full Newton at
    N = 256 (B3'), (d) the N = 64 fleet of 128 lanes under ActiveSet Newton
    and the LagrangianFilter, the Exact control and Globalized Newton (B2'),
    (e) the boxed QP at n = 1000 under ActiveSet Newton (B1').  Returns the
    launches of the card runs."""
    import multiprocessing

    import numpy as np
    import torch

    from pygradflow_torch import SolverStatus
    from pygradflow_torch.linalg import ldlt_kernels as lk

    totals = dict.fromkeys(("rl", "ll", "rl_batched"), 0)
    only = {"(c) Full": {"ll"}, "(e) QP": {"rl"}}
    pool = multiprocessing.get_context("spawn").Pool(workers)
    pending = {name: pool.apply_async(_cpu_reference, ("options", name)) for name in OPTIONS_RUNS[::-1]}

    def run(name):
        """A card run against the port's CPU run."""
        problem, params, x0, batched = _options_config(name)
        res, used, wall = _solve_once(problem, params, "cuda", x0, batched=batched)
        ref = pending[name].get(timeout=900)
        if batched:
            label = f"options {name} fleet"
            _expect_launches(label, used, {"rl_batched"})
            dx = _check_lanes(label, res, _as_result(ref, True), slice(0, CPU_LANES))
            if not torch.isfinite(res.x).all() or tuple(res.x.shape) != (FLEET_B, problem.num_vars):
                fail(f"{label}: solutions not finite or of the wrong shape")
            optimal = int((res.status == int(SolverStatus.Optimal)).sum())
            iters = int(res.iterations.max())
            print(
                f"{label} N={FLEET_N} B={FLEET_B}: {optimal}/{FLEET_B} Optimal, "
                f"lockstep iterations {iters}, lanes 0-{CPU_LANES - 1} {res.iterations[:CPU_LANES].tolist()}/"
                f"{res.accepted_steps[:CPU_LANES].tolist()} launches={used} launches/iter="
                f"{used['rl_batched'] / iters:.2f} |x-x_cpu|={dx:.3e} wall={wall:.3f} s "
                f"ms/iter={1e3 * wall / iters:.2f} solves/s={FLEET_B / wall:.1f} cpu_wall={ref['wall']:.3f} s [{card}]",
                flush=True,
            )
        else:
            label = f"{name} N={problem.num_vars}" if name == "(e) QP" else name
            _expect_launches(label, used, only.get(name, {"rl"}))
            dx = _hold(label, res, _as_result(ref, False), "cpu", require_optimal=False)
            print(
                f"options {label}: {res.status.name} {res.iterations}/{res.num_accepted_steps} launches={used} "
                f"launches/iter={sum(used.values()) / res.iterations:.2f} |x-x_cpu|={dx:.3e} wall={wall:.3f} s "
                f"ms/iter={1e3 * wall / res.iterations:.2f} cpu_wall={ref['wall']:.3f} s [{card}]",
                flush=True,
            )
        for k in totals:
            totals[k] += used[k]

    try:
        for name in OPTIONS_RUNS[:-1]:
            run(name)
        # (e) the boxed QP (n_pad 1024, m = 0, B1' only); the last KKT
        # matrix the card run hands B1' (positive definite, unit rows for
        # the active variables) is then held against the plain version
        kernel, kkt = lk.ldlt_factor_rl, []

        def recording(a):
            # the tier looks the wrapper up when a solver is built; the
            # launch is the path's own and counted by the wrapper
            if a.is_cuda:
                kkt[:] = [a.clone()]
            return kernel(a)

        lk.ldlt_factor_rl = recording
        try:
            run("(e) QP")
        finally:
            lk.ldlt_factor_rl = kernel
    finally:
        pool.terminate()
        pool.join()
    a64 = kkt[0].to(torch.float64)
    unit = int((torch.diagonal(a64) == 1.0).sum())
    qp_case = _factor_check(
        f"kernel ldlt_factor_rl n={OPTIONS_QP_N} (QP KKT, last of (e), {unit} unit rows)",
        kernel, lk.ldlt_factor_rl_ref, a64, 0, np.random.default_rng(SEED), card, lk.RL_BLOCK,
        torch.linalg.cholesky,
    )
    print(f"options launches: {totals}", flush=True)
    return totals, dict(case=f"QP KKT, last of phase 8 (e), {unit} unit rows", shape=list(a64.shape), **qp_case)


# GMRES at N = 32 and the boxed QP at n = 150, not N = 128 and n = 1000:
# PERF.md section 4 gives the cuts (the second, from N = 64 and n = 250, to
# keep the script within its time limit with phase 12)
LAST_N, LAST_LL_N, GMRES_N, LAST_QP_N = 128, 256, 32, 150
RCOND_RTOL = 1e-8


def _last_config(name):
    """Problem, params, start points and whether it is a batch, of the phase
    9 run ``name``; the card and the CPU reference build it alike."""
    import numpy as np

    from pygradflow_torch import LinearSolverType, Params
    from pygradflow_torch.runners.control import PendulumControl

    pallas = dict(linear_solver_type=LinearSolverType.PallasLDLT, iteration_limit=3000, validate_input=False)
    iterative = dict(pallas, step_solver_type="Symmetric")
    lanes = dict(validate_input=False, rho=1e-1)
    pendulum = {
        "(a) rcond": (LAST_N, dict(pallas, report_rcond=True)),
        "(a) rcond ll": (LAST_LL_N, dict(pallas, report_rcond=True)),
        "(b) collect_path": (LAST_N, dict(pallas, collect_path=True)),
        "(c) MINRES": (LAST_N, dict(iterative, linear_solver_type=LinearSolverType.MINRES)),
        "(c) GMRES": (GMRES_N, dict(iterative, linear_solver_type=LinearSolverType.GMRES)),
    }
    if name in pendulum:
        N, kwargs = pendulum[name]
        problem = PendulumControl(N=N)
        return problem, Params(**kwargs), problem.x0_trajectory(), False
    if name.startswith("(d)"):
        from tests.torch_parity import Rosenbrock

        x0 = np.random.default_rng(0).uniform(-1.5, 1.5, size=(HEADLINE_B, 2))
        return Rosenbrock(), Params(**lanes, step_control_type=name.split()[1]), x0, True
    if name == "(e) fleet rcond":
        problem = PendulumControl(N=FLEET_N)
        rng = np.random.default_rng(0)
        x0 = problem.x0_trajectory()[None, :] + 0.02 * rng.standard_normal((FLEET_B, problem.num_vars))
        return problem, Params(**dict(pallas, report_rcond=True)), x0, True
    assert name == "(f) BoxReduced QP"
    problem, x0 = boxed_qp(LAST_QP_N)
    params = Params(linear_solver_type=LinearSolverType.PallasLDLT, lamb_init=1e-12, iteration_limit=1000,
                    step_control_type="BoxReduced")
    return problem, params, x0, False


LAST_RUNS = [
    "(a) rcond", "(a) rcond ll", "(b) collect_path", "(c) MINRES", "(d) Optimizing", "(d) BoxReduced",
    "(e) fleet rcond", "(f) BoxReduced QP", "(c) GMRES",
]
"""The card's order; the CPU references start longest first, GMRES's."""


def _cpu_reference(phase, name):
    """The port's CPU run of the run ``name`` of phase 8 ("options") or 9
    ("last") in a worker process, as plain data: the first CPU_LANES lanes
    of a batch."""
    sys.path.insert(0, ROOT)
    import torch

    from pygradflow_torch import Solver
    from pygradflow_torch.parallel import BatchedSolver

    torch.set_num_threads(1)
    problem, params, x0, batched = {"options": _options_config, "last": _last_config}[phase](name)
    t0 = time.perf_counter()
    if batched:
        res = BatchedSolver(problem, params, device="cpu").solve(x0[:CPU_LANES])
        out = dict(status=res.status.tolist(), iterations=res.iterations.tolist(),
                   accepted_steps=res.accepted_steps.tolist(), x=res.x.numpy(),
                   rcond=None if res.rcond is None else res.rcond.numpy())
    else:
        res = Solver(problem, params, device="cpu").solve(torch.tensor(x0))
        out = dict(status=res.status.name, iterations=res.iterations, num_accepted_steps=res.num_accepted_steps,
                   x=res.x.numpy(), rcond=res.final_rcond)
        if params.collect_path:
            out.update(path=res.path.numpy(), model_times=res.model_times.numpy())
    return dict(out, wall=time.perf_counter() - t0)


def _as_result(ref, batched):
    """A CPU reference as the result objects ``_hold`` and ``_check_lanes``
    read."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from pygradflow_torch import SolverStatus

    if batched:
        return SimpleNamespace(**{k: np.asarray(ref[k]) for k in ("status", "iterations", "accepted_steps")},
                               x=torch.as_tensor(ref["x"]))
    return SimpleNamespace(status=SolverStatus[ref["status"]], iterations=ref["iterations"],
                           num_accepted_steps=ref["num_accepted_steps"], x=torch.as_tensor(ref["x"]))


def _rcond_close(label, ours, ref):
    import numpy as np

    ours, ref = np.atleast_1d(np.asarray(ours, dtype=float)), np.atleast_1d(np.asarray(ref, dtype=float))
    if not (np.isfinite(ours).all() and np.allclose(ours, ref, rtol=RCOND_RTOL, atol=0.0)):
        fail(f"{label}: rcond {ours.tolist()} on cuda, {ref.tolist()} on cpu")


def last_options_phase(card, workers=4):
    """Phase 9: BoxReduced and Optimizing, the rcond estimate, MINRES and
    GMRES and collect_path on the card, each held against the port's CPU
    run of the same configuration, which worker processes compute while the
    card runs.  Returns the launches of the card runs."""
    import multiprocessing

    import numpy as np
    import torch

    from pygradflow_torch import SolverStatus
    from pygradflow_torch.util import HOST_READS

    totals = dict.fromkeys(("rl", "ll", "rl_batched"), 0)
    only = {
        "(a) rcond": {"rl"}, "(a) rcond ll": {"ll"}, "(b) collect_path": {"rl"}, "(e) fleet rcond": {"rl_batched"},
    }
    beside = {
        "(a) rcond": ("pendulum", LAST_N), "(a) rcond ll": ("pendulum", LAST_LL_N),
        "(b) collect_path": ("pendulum", LAST_N), "(c) MINRES": ("pendulum", LAST_N),
        "(d) Optimizing": "headline", "(d) BoxReduced": "headline", "(e) fleet rcond": ("fleet", FLEET_N),
    }
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        pending = {name: pool.apply_async(_cpu_reference, ("last", name)) for name in LAST_RUNS[::-1]}
        for name in LAST_RUNS:
            problem, params, x0, batched = _last_config(name)
            HOST_READS.clear()
            res, used, wall = _solve_once(problem, params, "cuda", x0, batched=batched)
            reads = dict(HOST_READS)
            _expect_launches(f"last {name}", used, only.get(name, set()))
            ref = pending[name].get(timeout=900)
            label = f"last {name}"
            if batched:
                iters = int(res.iterations.max())
                dx = _check_lanes(label, res, _as_result(ref, True), slice(0, CPU_LANES))
                optimal = int((res.status == int(SolverStatus.Optimal)).sum())
                if optimal != x0.shape[0] or not torch.isfinite(res.x).all():
                    fail(f"{label}: {optimal}/{x0.shape[0]} lanes Optimal")
                if params.report_rcond:
                    _rcond_close(label, res.rcond[:CPU_LANES].cpu().numpy(), ref["rcond"])
                counts = (f"{optimal}/{x0.shape[0]} Optimal, lockstep iterations {iters}, lanes 0-{CPU_LANES - 1} "
                          f"{res.iterations[:CPU_LANES].tolist()}/{res.accepted_steps[:CPU_LANES].tolist()}")
            else:
                iters = res.iterations
                dx = _hold(label, res, _as_result(ref, False), "cpu")
                counts = f"{res.status.name} {res.iterations}/{res.num_accepted_steps}"
                if params.report_rcond:
                    _rcond_close(label, res.final_rcond, ref["rcond"])
                    N = beside[name][1]
                    if sum(used.values()) != SLICE_LAUNCHES[N]:
                        fail(f"{label}: launches {used}, phase 4 launched {SLICE_LAUNCHES[N]} at N={N}")
                    counts += f" rcond={res.final_rcond:.6e} (cpu {ref['rcond']:.6e})"
                if params.collect_path:
                    path, times = res.path.cpu().numpy(), res.model_times.cpu().numpy()
                    if path.shape != (problem.num_vars + problem.num_cons, res.num_accepted_steps + 1):
                        fail(f"{label}: path of shape {path.shape}")
                    if not (np.allclose(path, ref["path"], rtol=X_TOL, atol=X_TOL)
                            and np.allclose(times, ref["model_times"], rtol=X_TOL, atol=X_TOL)):
                        fail(f"{label}: path or model times differ from the cpu run")
                    counts += f" path {path.shape[1]} columns, t_end={times[-1]:.6e}"
            launches = sum(used.values())
            extra = ""
            if name in beside:
                extra = f" (phase {4 if beside[name][0] == 'pendulum' else 5 if beside[name][0] == 'fleet' else 6}: "
                extra += f"{PHASE_MS[beside[name]]:.2f} ms/iter)" if beside[name] in PHASE_MS else "not run)"
            read_text = " ".join(f"{k}={v} ({v / iters:.2f}/iter)" for k, v in reads.items())
            print(
                f"{label}: {counts} launches={used} launches/iter={launches / iters:.2f} |x-x_cpu|={dx:.3e} "
                f"wall={wall:.3f} s ms/iter={1e3 * wall / iters:.2f}{extra} host reads {read_text or 'none'} "
                f"cpu_wall={ref['wall']:.3f} s [{card}]",
                flush=True,
            )
            for k in totals:
                totals[k] += used[k]
    print(f"last options launches: {totals}", flush=True)
    return totals

# phase 10: the continuous engine.  Each run beside the JAX package's counts
# on the CPU (segments / integration steps / Newton steps): from the run's
# own start, and the counts the run must equal, those of the JAX run whose
# trajectory the port takes.  Where a last-bit difference parts the two
# packages, that is the JAX run from a start a few ulps away
# (tests/test_torch_integration_solver.py and _batch.py hold these against
# live JAX runs; ROADMAP Queue C); None where no such start was found, and
# then the segments must equal.  (d) holds lanes 0-7 against the port's
# single flat solves too.
INTEG = dict(iteration_limit=1000, rho=1e-2)
INTEG_B, INTEG_B_SMALL, INTEG_LANES = 1024, 64, 8
_HS71_SDIRK4 = ((10, 195, 2432), (9, 189, 2400))  # x0[2] = 5 + 2^-50
JAX_INTEG = {
    "(a) HS71 TRBDF2": ((10, 357, 1785),) * 2, "(a) HS71 SDIRK4": _HS71_SDIRK4,
    "(a) Tame TRBDF2": ((12, 684, 2697),) * 2, "(a) Tame SDIRK4": ((11, 240, 2318),) * 2,
    "(b) SimpleUnbounded Euler": ((1, 21, 63),) * 2, "(b) ActiveSetChange Euler": ((1, 1280, 7680),) * 2,
    "(b) SingleActiveSet Euler": ((2, 4955, 29730),) * 2, "(b) HS71 Euler flat": ((10, 4027, 37214), None),
    "(c) HS71 SDIRK4 device": _HS71_SDIRK4, "(c) HS71 SDIRK4 flat": _HS71_SDIRK4,
}
JAX_INTEG_LANES = [
    ((11, 194, 2463), (12, 202, 2511)), ((12, 192, 2448),) * 2, ((10, 186, 2350),) * 2, ((12, 204, 2582),) * 2,
    ((10, 191, 2358), (9, 181, 2297)), ((13, 205, 2538), (12, 196, 2483)), ((10, 186, 2344),) * 2,
    ((12, 198, 2447), (12, 200, 2463)),
]
INTEG_RUNS = [
    "(a) HS71 TRBDF2", "(a) HS71 SDIRK4", "(a) Tame TRBDF2", "(a) Tame SDIRK4",
    "(b) SimpleUnbounded Euler", "(b) ActiveSetChange Euler", "(b) SingleActiveSet Euler",
    "(c) HS71 SDIRK4 device", "(c) HS71 SDIRK4 flat",
]
INTEG_LAST = "(b) HS71 Euler flat"
"""Run after (d): its CPU reference, started first in a worker of its own,
is the longest (146 s on the card's host), and the card's other runs
overlap it."""
PARTED = []  # (label, card counts, cpu counts) of runs whose counts part


def _integ_config(name):
    """Problem, params, start point of the phase 10 run ``name``; the card
    and the CPU reference build it alike."""
    import numpy as np

    import tests.torch_parity as tp
    from pygradflow_torch import IntegrationMethod, Params

    method = {"TRBDF2": "TRBDF2", "SDIRK4": "SDIRK4", "Euler": "ImplicitEuler"}
    kwargs = dict(INTEG)
    for word in name.split():
        if word in method:
            kwargs["integration_method"] = IntegrationMethod[method[word]]
    if name.endswith("device") or name.endswith("flat"):
        kwargs["integration_device_loop"] = True
    if name.endswith("flat"):
        kwargs["time_limit"] = 9000.0
    starts = {
        "HS71": (tp.HS71Explicit, [1.0, 5.0, 5.0, 1.0, 0.0], [0.0, 0.0]),
        "Tame": (tp.TameExplicit, [0.0, 0.0], [0.0]),
        "SimpleUnbounded": (tp.SimpleUnboundedProblem, [0.0], []),
        "ActiveSetChange": (tp.ActiveSetChangeProblem, [10.0], []),
        "SingleActiveSet": (tp.SingleActiveSetProblem, [1.5, 10.0], []),
    }
    cls, x0, y0 = starts[name.split()[1]]
    return cls(), Params(**kwargs), np.array(x0), np.array(y0)


def _integ_batch(B):
    """bench_integration_batch.py's configuration: B perturbed HS71 starts
    from default_rng(7), SDIRK4, integration_max_steps=50_000."""
    import numpy as np

    import tests.torch_parity as tp
    from pygradflow_torch import IntegrationMethod, Params

    rng = np.random.default_rng(7)
    x0s = np.clip(
        np.array([1.0, 5.0, 5.0, 1.0, 0.0])[None, :] + rng.uniform(-0.1, 0.1, size=(B, 5)),
        np.array([1.0, 1.0, 1.0, 1.0, 0.0]), np.array([5.0, 5.0, 5.0, 5.0, 2.0]),
    )
    params = Params(**INTEG, integration_max_steps=50_000, integration_method=IntegrationMethod.SDIRK4)
    return tp.HS71Explicit(), params, x0s, np.zeros((B, 2))


def _integ_reference(name):
    """The port's CPU run of the phase 10 run ``name`` (in a worker process):
    a single solve, or for "lane k" the single flat solve of lane k of (d)."""
    sys.path.insert(0, ROOT)
    import torch

    from pygradflow_torch.integration import IntegrationSolver

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if name.startswith("lane"):
        problem, params, x0s, y0s = _integ_batch(INTEG_LANES)
        k = int(name.split()[1])
        params = params.__class__(**{**params.__dict__, "integration_device_loop": True, "time_limit": 9000.0})
        x0, y0 = x0s[k], y0s[k]
    else:
        problem, params, x0, y0 = _integ_config(name)
    res = IntegrationSolver(problem, params, device="cpu").solve(torch.tensor(x0), torch.tensor(y0))
    return dict(status=res.status.name, counts=(res.iterations, res.num_integration_steps, res.num_newton_steps),
                rho=res.final_rho, x=res.x.numpy(), wall=time.perf_counter() - t0)


def _hold_counts(label, status, counts, x, ref, require_optimal=True):
    """A card run against its CPU reference: equal status; equal counts and
    x within 1e-8, or, where the roundings part the counts, status Optimal
    and x within X_TOL (recorded in PARTED)."""
    import numpy as np

    if status != ref["status"] or (require_optimal and status != "Optimal"):
        fail(f"{label}: status {status}, cpu {ref['status']}")
    dx = float(np.abs(np.asarray(x) - ref["x"]).max()) if ref["x"].size else 0.0
    if not np.isfinite(np.asarray(x)).all():
        fail(f"{label}: solution not finite")
    if tuple(counts) == tuple(ref["counts"]):
        if status == "Optimal" and not dx <= 1e-8:
            fail(f"{label}: equal counts, x differs from the cpu run by {dx:.3e}")
        return dx, "equal"
    if status != "Optimal" or not dx <= X_TOL:
        fail(f"{label}: counts {counts}, cpu {ref['counts']}, |dx| {dx:.3e}")
    PARTED.append((label, tuple(counts), tuple(ref["counts"])))
    return dx, "parted"


def _hold_jax(label, counts, jax):
    """A run's counts against the JAX package's ``(nominal, trajectory)``
    counts: equal to the trajectory's, or with no trajectory found equal in
    segments.  Returns the text to print."""
    nominal, trajectory = jax
    if trajectory is None:
        if counts[0] != nominal[0]:
            fail(f"{label}: {counts[0]} segments, JAX {nominal[0]}")
        return f"JAX {'/'.join(map(str, nominal))}, parted past the segments"
    if tuple(counts) != trajectory:
        fail(f"{label}: counts {counts}, JAX's trajectory {trajectory}")
    if trajectory == nominal:
        return f"JAX {'/'.join(map(str, nominal))} equal"
    return f"JAX {'/'.join(map(str, nominal))}, from a start ulps away {'/'.join(map(str, trajectory))} equal"


def _graph_unit_ms(card, solver, x0s, y0s, runs=20):
    """CUDA-event ms of one work unit at the full width from the batch's
    start: the fast graph (Newton capped, no escalation), the full graph
    (every loop to its full trip count) and the eager unit (host reads)."""
    import torch

    runner = solver.runner
    x, y = torch.func.vmap(solver.inner.transform.transform_sol)(
        torch.tensor(x0s, device="cuda"), torch.tensor(y0s, device="cuda")
    )
    state = runner.init(x, y)
    keys = tuple(state)
    runner._keys = keys
    args = tuple(state[k] for k in keys)
    runner._pair(*args)  # loads the start into the graphs' inputs
    fast_graph, full_graph = runner._pair.graphs(*args)
    fast = cuda_ms(fast_graph.replay, runs)
    full = cuda_ms(full_graph.replay, runs)
    eager = cuda_ms(lambda: runner._chunk(dict(state), 1), 3)
    print(f"continuous graph unit B={x.shape[0]}: fast {fast:.2f} ms, full {full:.2f} ms, eager {eager:.2f} ms [{card}]",
          flush=True)


def continuous_references(workers=4):
    """Start the port's CPU runs of phase 10: the longest (``INTEG_LAST``) in
    a worker of its own, the rest in ``workers`` more, in the order the card
    needs them.  Returns the two pools and the pending results by name."""
    import multiprocessing

    spawn = multiprocessing.get_context("spawn")
    last, pool = spawn.Pool(1), spawn.Pool(workers)
    pending = {INTEG_LAST: last.apply_async(_integ_reference, (INTEG_LAST,))}
    for name in INTEG_RUNS + [f"lane {k}" for k in range(INTEG_LANES)]:
        pending[name] = pool.apply_async(_integ_reference, (name,))
    return (last, pool), pending


def continuous_phase(card):
    """Phase 10: the continuous engine on the card, each run held against the
    port's CPU run of the same configuration (``continuous_references``, run
    in worker processes while the card runs this phase) and against the JAX
    package's counts (``JAX_INTEG``)."""
    import numpy as np
    import torch

    from pygradflow_torch import SolverStatus
    from pygradflow_torch.integration import BatchedIntegrationSolver, IntegrationSolver
    from pygradflow_torch.util import HOST_READS

    t_phase = time.perf_counter()
    lane_names = [f"lane {k}" for k in range(INTEG_LANES)]
    (last, pool), pending = continuous_references()
    with last, pool:

        def single(name):
            problem, params, x0, y0 = _integ_config(name)
            HOST_READS.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = IntegrationSolver(problem, params).solve(torch.tensor(x0, device="cuda"), torch.tensor(y0, device="cuda"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if res.x.device.type != "cuda":
                fail(f"continuous {name}: solved on {res.x.device}")
            reads = dict(HOST_READS)
            counts = (res.iterations, res.num_integration_steps, res.num_newton_steps)
            ref = pending[name].get(timeout=900)
            require = name.split()[1] != "SimpleUnbounded"
            dx, how = _hold_counts(f"continuous {name}", res.status.name, counts, res.x.cpu().numpy(), ref, require)
            jax = _hold_jax(f"continuous {name}", counts, JAX_INTEG[name])
            per, units = ("unit", res.num_work_units) if name.endswith("flat") else ("step", counts[1])
            print(
                f"continuous {name}: {res.status.name} {counts[0]}/{counts[1]}/{counts[2]} rho={res.final_rho:.0e} "
                f"(cpu {ref['counts'][0]}/{ref['counts'][1]}/{ref['counts'][2]} {how}; {jax}) "
                f"|x-x_cpu|={dx:.3e} wall={wall:.3f} s "
                f"ms/{per}={1e3 * wall / max(units, 1):.2f} host reads {reads} cpu_wall={ref['wall']:.1f} s [{card}]",
                flush=True,
            )

        for name in INTEG_RUNS:
            single(name)

        # (d) the batch at full width, then at 64 lanes: lanes 0-7 against
        # the CPU's single flat solves and JAX's lanes
        lane_refs = [pending[n].get(timeout=900) for n in lane_names]
        solver = None
        for B in (INTEG_B, INTEG_B_SMALL):
            problem, params, x0s, y0s = _integ_batch(B)
            if solver is None:
                solver = BatchedIntegrationSolver(problem, params)
            HOST_READS.clear()
            solver.runner._pair.replays.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solver.solve(torch.tensor(x0s, device="cuda"), torch.tensor(y0s, device="cuda"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reads, replays = dict(HOST_READS), dict(solver.runner._pair.replays)
            status = res.status.cpu().numpy()
            optimal = int((status == int(SolverStatus.Optimal)).sum())
            if optimal != B or not torch.isfinite(res.x).all() or tuple(res.x.shape) != (B, 5):
                fail(f"continuous (d) B={B}: {optimal}/{B} Optimal, statuses {np.bincount(status).tolist()}")
            segs, steps = res.iterations.cpu().numpy(), res.num_integration_steps.cpu().numpy()
            units = res.units.cpu().numpy()
            held, jax_held = [], []
            for k in range(INTEG_LANES):
                counts = (int(segs[k]), int(steps[k]), int(res.num_newton_steps[k]))
                _, how = _hold_counts(f"continuous (d) B={B} lane {k}", SolverStatus(int(status[k])).name, counts,
                                      res.x[k].cpu().numpy(), lane_refs[k])
                held.append(how)
                jax_held.append(_hold_jax(f"continuous (d) B={B} lane {k}", counts, JAX_INTEG_LANES[k]))
            lanes = [f"{int(segs[k])}/{int(steps[k])}" for k in range(INTEG_LANES)]
            jax_equal = sum(text.endswith("equal") and "ulps" not in text for text in jax_held)
            print(
                f"continuous (d) B={B}: {optimal}/{B} Optimal (success {optimal / B:.3f}), segments max "
                f"{int(segs.max())} sum {int(segs.sum())}, steps max {int(steps.max())} sum {int(steps.sum())}, "
                f"units max {int(units.max())} sum {int(units.sum())}, tiers {solver.tiers}, lanes 0-7 {lanes} "
                f"(cpu flat {['%d/%d' % r['counts'][:2] for r in lane_refs]}: {held.count('equal')} equal; JAX's "
                f"lanes: {jax_equal} of 8 from the same start, the rest from starts one ulp away) "
                f"wall={wall:.3f} s solves/s={B / wall:.1f} "
                f"ms/unit={1e3 * wall / int(units.max()):.2f} graph replays {replays} host reads {reads} [{card}]",
                flush=True,
            )
            if B == INTEG_B:
                REFERENCES["integ"] = res
                _graph_unit_ms(card, solver, x0s, y0s)
        single(INTEG_LAST)
    for label, ours, theirs in PARTED:
        print(f"continuous parted: {label} card {ours} cpu {theirs}", flush=True)
    print(f"continuous phase: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)


# phase 11: single precision, the mixed-precision sweep, checkpoint and
# resume, the display, derivative checks and multistart.  The JAX package's
# counts on the CPU (tests/test_torch_precision.py and
# tests/test_torch_mixed_multistart.py hold them against live JAX runs):
# bench.py's first 8 f32 lanes, where lane 6 stops on the edge of opt_tol in
# JAX's vmapped run (6) and takes 7 in the single solves of both packages;
# the mixed totals; bench_hs.py's first 8 HS71 lanes.
SINGLE = dict(precision="Single", opt_tol=1e-4, lamb_min=1e-6)
F32_X_TOL = 1e-3  # x of an f32 solve at opt_tol 1e-4, card against cpu
JAX_F32_LANES = [26, 50, 7, 26, 29, 6, 6, 16]
JAX_F32_SINGLE_LANE6 = 7
JAX_MIXED_LANES = [29, 53, 10, 29, 32, 9, 9, 19]
JAX_HS71_F32_LANES = [18, 19, 19, 18, 21, 20, 20, 20]
JAX_HS71_MIXED_LANES = [21, 20, 22, 20, 25, 22, 24, 23]
JAX_TAME_F32 = (7, 622, 9946)
HS71_F32_B, MULTISTART_B, PRECISION_N, CHECKPOINT_N = 4096, 1024, 128, 128
PRECISION_RUNS = ["(a) f32", "(b) mixed", "(c) hs71 f32", "(c) hs71 mixed", "(d) pendulum f32", "(e) fleet mixed",
                  "(h) multistart", "(i) tame f32"]


def _hs71_starts(batch):
    """bench_hs.py:47-53's starts."""
    import numpy as np

    rng = np.random.default_rng(1)
    base = np.array([1.0, 5.0, 5.0, 1.0, 0.0])
    pert = rng.uniform(-0.5, 0.5, size=(batch, 5))
    return np.clip(base[None, :] + pert, np.array([1.0, 1.0, 1.0, 1.0, 0.0]), np.array([5.0, 5.0, 5.0, 5.0, 10.0]))


def _precision_config(name):
    """Kind ("batch", "mixed", "single", "multistart" or "integration"),
    problem, params and starts of the phase 11 run ``name``; the card and
    the CPU reference build it alike."""
    import numpy as np

    import tests.torch_parity as tp
    from pygradflow_torch import LinearSolverType, Params
    from pygradflow_torch.runners.control import PendulumControl

    bench = dict(validate_input=False, jit_chunk=128)
    pallas = dict(linear_solver_type=LinearSolverType.PallasLDLT, iteration_limit=3000, validate_input=False)
    rosenbrock = np.random.default_rng(0).uniform(-1.5, 1.5, size=(HEADLINE_B, 2))
    if name == "(a) f32":
        return "batch", tp.Rosenbrock(), Params(**bench, **SINGLE), rosenbrock
    if name == "(a) f64":
        return "batch", tp.Rosenbrock(), Params(**bench), rosenbrock
    if name == "(b) mixed":
        return "mixed", tp.Rosenbrock(), Params(**bench), rosenbrock
    if name == "(c) hs71 f32":
        return "batch", tp.HS71(), Params(**bench, **SINGLE), _hs71_starts(HS71_F32_B)
    if name == "(c) hs71 mixed":
        return "mixed", tp.HS71(), Params(**bench), _hs71_starts(HEADLINE_B)
    if name == "(d) pendulum f32":
        problem = PendulumControl(N=PRECISION_N)
        return "single", problem, Params(**pallas, **SINGLE), problem.x0_trajectory()
    if name == "(e) fleet mixed":
        problem = PendulumControl(N=FLEET_N)
        rng = np.random.default_rng(0)
        x0 = problem.x0_trajectory()[None, :] + 0.02 * rng.standard_normal((FLEET_B, problem.num_vars))
        return "mixed", problem, Params(**pallas), x0
    if name == "(h) multistart":
        return "multistart", tp.FourWells(), Params(), np.random.default_rng(11).uniform(-2.0, 2.0, (MULTISTART_B, 2))
    if name == "(i) tame f32":
        return "integration", tp.TameExplicit(), Params(iteration_limit=1000, rho=1e-2, **SINGLE), np.zeros(2)
    raise ValueError(name)


def _precision_solve(name, device, lanes=None):
    """Run ``name`` on ``device`` (its first ``lanes`` starts when given);
    returns the result and, for a mixed run, its bulk stage's result."""
    import numpy as np
    import torch

    from pygradflow_torch import Solver
    from pygradflow_torch.integration import IntegrationSolver
    from pygradflow_torch.parallel import BatchedSolver, MixedPrecisionSolver, multistart_solve

    kind, problem, params, x0 = _precision_config(name)
    if lanes is not None:
        x0 = x0[:lanes]
    x0 = torch.tensor(x0, device=device)
    if kind == "batch":
        return BatchedSolver(problem, params, device=device).solve(x0), None
    if kind == "mixed":
        solver = MixedPrecisionSolver(problem, params, device=device)
        return solver.solve(x0), solver.bulk_result
    if kind == "single":
        return Solver(problem, params, device=device).solve(x0), None
    if kind == "multistart":
        return multistart_solve(problem, x0, params, device=device), None
    return IntegrationSolver(problem, params, device=device).solve(x0, torch.zeros(1, dtype=torch.float64, device=device)), None


def _precision_reference(name):
    """The port's CPU run of the phase 11 run ``name`` (in a worker
    process): every start of a single solve or a multistart, the first 8
    lanes of a batch."""
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    kind = _precision_config(name)[0]
    lanes = None if kind in ("single", "multistart", "integration") else CPU_LANES
    res, bulk = _precision_solve(name, "cpu", lanes)
    out = dict(wall=time.perf_counter() - t0)
    if kind in ("batch", "mixed"):
        out.update(status=res.status.tolist(), iterations=res.iterations.tolist(),
                   accepted=res.accepted_steps.tolist(), x=res.x.numpy())
        if bulk is not None:
            out["bulk"] = bulk.iterations.tolist()
    elif kind == "multistart":
        out.update(best=res.best_index, obj=float(res.obj), num_optimal=res.num_optimal, x=res.x.numpy())
    elif kind == "single":
        out.update(status=res.status.name, counts=(res.iterations, res.num_accepted_steps), x=res.x.numpy())
    else:
        out.update(status=res.status.name, counts=(res.iterations, res.num_integration_steps, res.num_newton_steps),
                   x=res.x.numpy())
    return out


def _solves_per_s(solver, x0, runs=5):
    """bench.py's timing: a warm-up, then the minimum of ``runs`` walls;
    returns the last result and its solves per second."""
    import torch

    solver.solve(x0)
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(x0)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return res, x0.shape[0] / best


def precision_phase(card):
    """Phase 11: Precision.Single, MixedPrecisionSolver, checkpoint and
    resume, the display, derivative checks and multistart on the card, each
    run held against the port's CPU run of the same configuration (computed
    by worker processes started with the phase) and, for (a)-(c), against
    the JAX package's counts.  Returns the launches of the card runs."""
    import logging
    import multiprocessing
    import tempfile

    import numpy as np
    import torch

    from pygradflow_torch import DerivCheck, LinearSolverType, Params, Solver, SolverStatus
    from pygradflow_torch.deriv_check import DerivError
    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.linalg.ldlt import ldlt_num_neg_eigvals
    from pygradflow_torch.parallel import BatchedSolver, MixedPrecisionSolver
    from pygradflow_torch.runners.control import PendulumControl

    import tests.torch_parity as tp

    t_phase = time.perf_counter()
    totals = dict.fromkeys(("rl", "ll", "rl_batched"), 0)
    failures, parted = [], []

    def check(ok, msg):
        if not ok:
            failures.append(msg)
            print(f"precision FAILED: {msg}", flush=True)
        return ok

    def reset():
        for key in lk.LAUNCHES:
            lk.LAUNCHES[key] = 0

    def launched(label, only):
        used = dict(lk.LAUNCHES)
        check(all((used[k] > 0) == (k in only) for k in used), f"{label}: launches {used}, expected only {sorted(only)}")
        for k in totals:
            totals[k] += used[k]
        return used

    def lanes(label, res, ref, tol):
        """Lanes 0-7 against the CPU run: equal status, counts and x within
        ``tol``; or, where f32 rounding parts a lane's counts (a lane whose
        residual ends within rounding of opt_tol), both Optimal and x
        within ``tol``, listed in ``parted``."""
        x = res.x[:CPU_LANES].cpu().numpy()
        for k in range(CPU_LANES):
            ours = (int(res.status[k]), int(res.iterations[k]), int(res.accepted_steps[k]))
            theirs = (ref["status"][k], ref["iterations"][k], ref["accepted"][k])
            dx = float(np.abs(x[k] - ref["x"][k]).max())
            check(ours[0] == theirs[0] == int(SolverStatus.Optimal) and dx <= tol,
                  f"{label} lane {k}: {ours}, cpu {theirs}, |dx| {dx:.3e}")
            if ours != theirs:
                parted.append((f"{label} lane {k}", ours[1:], theirs[1:], dx))
        dx = float(np.abs(x - ref["x"]).max())
        optimal = int((res.status == int(SolverStatus.Optimal)).sum())
        check(optimal == res.status.shape[0] and bool(torch.isfinite(res.x).all()),
              f"{label}: {optimal}/{res.status.shape[0]} lanes Optimal")
        return optimal, dx

    with multiprocessing.get_context("spawn").Pool(3) as pool:
        pending = {name: pool.apply_async(_precision_reference, (name,)) for name in PRECISION_RUNS}

        # (a) bench.py's f32 headline, beside the f64 headline timed alike
        rates = {}
        x0 = None
        for name in ("(a) f64", "(a) f32", "(b) mixed"):
            kind, problem, params, starts = _precision_config(name)
            x0 = torch.tensor(starts, device="cuda")
            solver = (MixedPrecisionSolver(problem, params) if kind == "mixed" else BatchedSolver(problem, params))
            reset()
            res, rate = _solves_per_s(solver, x0)
            launched(name, set())
            rates[name] = rate
            err = float((res.x - 1.0).abs().max())
            limit = 1e-2 if name == "(a) f32" else 1e-4
            check(err < limit, f"{name}: |x - 1| = {err:.3e}, bench.py's limit {limit}")
            check(res.x.dtype == (torch.float32 if name == "(a) f32" else torch.float64), f"{name}: x of {res.x.dtype}")
            if name == "(a) f64":
                optimal = int((res.status == int(SolverStatus.Optimal)).sum())
                check(optimal == HEADLINE_B, f"(a) f64: {optimal}/{HEADLINE_B} Optimal")
                print(f"precision (a) f64 headline B={HEADLINE_B}: {optimal}/{HEADLINE_B} Optimal |x-1|={err:.3e} "
                      f"solves/s={rate:.1f} (warm-up, min of 5) [{card}]", flush=True)
                continue
            ref = pending[name].get(timeout=900)
            optimal, dx = lanes(name, res, ref, F32_X_TOL if name == "(a) f32" else X_TOL)
            if name == "(a) f32":
                jax_ok = [ref["iterations"][k] == JAX_F32_LANES[k] for k in range(CPU_LANES) if k != 6]
                check(all(jax_ok) and ref["iterations"][6] == JAX_F32_SINGLE_LANE6,
                      f"(a) f32: cpu lanes {ref['iterations']}, JAX {JAX_F32_LANES} (lane 6 single {JAX_F32_SINGLE_LANE6})")
                jax = f"JAX lanes {JAX_F32_LANES}, lane 6 single {JAX_F32_SINGLE_LANE6}"
            else:
                check(ref["iterations"][:6] + ref["iterations"][7:] == JAX_MIXED_LANES[:6] + JAX_MIXED_LANES[7:],
                      f"(b) mixed: cpu totals {ref['iterations']}, JAX {JAX_MIXED_LANES}")
                bulk = solver.bulk_result.iterations[:CPU_LANES].tolist()
                jax = f"JAX totals {JAX_MIXED_LANES}, bulk {bulk}, cpu bulk {ref['bulk']}"
            print(
                f"precision {name} B={HEADLINE_B}: {optimal}/{HEADLINE_B} Optimal |x-1|={err:.3e} lanes 0-7 "
                f"{res.iterations[:CPU_LANES].tolist()} (cpu {ref['iterations']}; {jax}) |x-x_cpu|={dx:.3e} "
                f"solves/s={rate:.1f} "
                f"(warm-up, min of 5) vs f64 {rates['(a) f64']:.1f}: ratio {rate / rates['(a) f64']:.3f} "
                f"cpu_wall={ref['wall']:.1f} s [{card}]",
                flush=True,
            )
        print(f"precision headline solves/s f64 {rates['(a) f64']:.1f} f32 {rates['(a) f32']:.1f} "
              f"mixed {rates['(b) mixed']:.1f} mixed/f64 {rates['(b) mixed'] / rates['(a) f64']:.3f} [{card}]", flush=True)

        # (c) bench_hs.py's f32_4096_tol4 and mixed_16384 on HS71
        for name, jax_lanes in (("(c) hs71 f32", JAX_HS71_F32_LANES), ("(c) hs71 mixed", JAX_HS71_MIXED_LANES)):
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, _ = _precision_solve(name, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched(name, set())
            ref = pending[name].get(timeout=900)
            optimal, dx = lanes(name, res, ref, F32_X_TOL if "f32" in name else X_TOL)
            check(ref["iterations"] == jax_lanes, f"{name}: cpu lanes {ref['iterations']}, JAX {jax_lanes}")
            B = res.status.shape[0]
            print(f"precision {name} B={B}: success {optimal / B:.3f} lanes 0-7 {res.iterations[:CPU_LANES].tolist()} "
                  f"(cpu {ref['iterations']}, equal to JAX's) |x-x_cpu|={dx:.3e} wall={wall:.3f} s "
                  f"solves/s={B / wall:.1f} [{card}]", flush=True)

        # (d) the pendulum at N=128 in f32 through B1', then its last KKT
        # matrix against the plain version
        kernel, kkt = lk.ldlt_factor_rl, []

        def recording(a):
            if a.is_cuda:
                kkt[:] = [a.clone()]
            return kernel(a)

        name = "(d) pendulum f32"
        lk.ldlt_factor_rl = recording
        try:
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, _ = _precision_solve(name, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            lk.ldlt_factor_rl = kernel
        used = launched(name, {"rl"})
        ref = pending[name].get(timeout=900)
        dx = float(np.abs(res.x.cpu().numpy() - ref["x"]).max())
        counts = (res.iterations, res.num_accepted_steps)
        check(res.status.name == ref["status"] == "Optimal" and res.x.dtype == torch.float32 and dx <= F32_X_TOL,
              f"{name}: {res.status.name} {counts} x of {res.x.dtype} |x-x_cpu| {dx:.3e}, cpu {ref['status']}")
        if counts != tuple(ref["counts"]):
            parted.append((name, counts, tuple(ref["counts"]), dx))
        print(f"precision {name} N={PRECISION_N}: {res.status.name} {res.iterations}/{res.num_accepted_steps} "
              f"(cpu {'/'.join(map(str, ref['counts']))}) launches={used} |x-x_cpu|={dx:.3e} wall={wall:.3f} s "
              f"ms/iter={1e3 * wall / res.iterations:.2f} [{card}]", flush=True)
        a32 = kkt[0]
        check(a32.dtype == torch.float32, f"{name}: the KKT matrix reached B1' as {a32.dtype}")
        neg = int(ldlt_num_neg_eigvals(lk.ldlt_factor_rl_ref(a32.contiguous())))
        _factor_check(f"kernel ldlt_factor_rl n={a32.shape[0]} (f32 KKT, last of phase 11 (d), {neg} negative)",
                      kernel, lk.ldlt_factor_rl_ref, a32.to(torch.float64), neg, np.random.default_rng(SEED), card,
                      lk.RL_BLOCK)

        # (e) the mixed fleet: B2' in both stages
        name = "(e) fleet mixed"
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, bulk = _precision_solve(name, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = launched(name, {"rl_batched"})
        ref = pending[name].get(timeout=900)
        optimal, dx = lanes(name, res, ref, X_TOL)
        print(f"precision {name} N={FLEET_N} B={FLEET_B}: {optimal}/{FLEET_B} Optimal, lanes 0-7 totals "
              f"{res.iterations[:CPU_LANES].tolist()} bulk {bulk.iterations[:CPU_LANES].tolist()} (cpu {ref['iterations']}"
              f" bulk {ref['bulk']}) "
              f"launches={used} |x-x_cpu|={dx:.3e} wall={wall:.3f} s solves/s={FLEET_B / wall:.1f} [{card}]",
              flush=True)

        # (f) checkpoint and resume at N=128 in f64, bit for bit
        problem = PendulumControl(N=CHECKPOINT_N)
        base = dict(linear_solver_type=LinearSolverType.PallasLDLT, iteration_limit=3000, validate_input=False)
        x0 = torch.tensor(problem.x0_trajectory(), device="cuda")
        full = Solver(problem, Params(**base)).solve(x0)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "state.npz")
            cut = Solver(problem, Params(**{**base, "iteration_limit": 8}, jit_chunk=4)).solve(x0, checkpoint_path=path)
            resumed = Solver(problem, Params(**base, jit_chunk=4)).solve(x0, checkpoint_path=path, resume=True)
        same = (resumed.iterations, resumed.num_accepted_steps) == (full.iterations, full.num_accepted_steps)
        bitwise = torch.equal(resumed.x, full.x) and torch.equal(resumed.y, full.y)
        check(cut.iterations == 8 and same and bitwise and full.success,
              f"(f) checkpoint: cut {cut.iterations}, resumed {resumed.iterations}/{resumed.num_accepted_steps}, "
              f"full {full.iterations}/{full.num_accepted_steps}, bitwise {bitwise}")
        print(f"precision (f) checkpoint N={CHECKPOINT_N}: cut at {cut.iterations} ({cut.status.name}), resumed "
              f"{resumed.iterations}/{resumed.num_accepted_steps}, uninterrupted {full.iterations}/"
              f"{full.num_accepted_steps}, x and y bit for bit: {bitwise} [{card}]", flush=True)

        # (g) the display and the derivative checks on HS71
        hs_x0 = torch.tensor([1.0, 5.0, 5.0, 1.0, 0.0], device="cuda")
        rows = []

        class Rows(logging.Handler):
            def emit(self, record):
                rows.append(record.getMessage())

        handler, logger = Rows(), logging.getLogger("gradflow_torch")
        walls = {}
        for shown in (False, True, False, True):
            params = Params(display=shown, display_interval=0.0)
            rows.clear()
            logger.addHandler(handler)
            level = logger.level
            logger.setLevel(logging.INFO)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = Solver(tp.HS71(), params).solve(hs_x0)
                torch.cuda.synchronize()
                walls[shown] = (time.perf_counter() - t0, res)
            finally:
                logger.removeHandler(handler)
                logger.setLevel(level)
            data = [r for r in rows if r.split() and r.split()[0].isdigit()]
            check(len(data) == (res.iterations if shown else 0), f"(g) display={shown}: {len(data)} rows")
        plain, shown = walls[False][1], walls[True][1]
        check((shown.iterations, shown.num_accepted_steps) == (plain.iterations, plain.num_accepted_steps)
              and torch.equal(shown.x, plain.x), "(g) display: the counts or x differ from the run without display")
        Solver(tp.HS71(), Params(deriv_check=DerivCheck.CheckAll)).solve(hs_x0)
        try:
            Solver(tp.WrongGradient(), Params(deriv_check=DerivCheck.CheckFirst)).solve(torch.ones(2, device="cuda"))
            check(False, "(g) a wrong gradient passed the derivative check")
        except DerivError as e:
            check(e.invalid_indices.tolist() == [[0, 1]], f"(g) invalid indices {e.invalid_indices.tolist()}")
        print(f"precision (g) HS71 display: {plain.iterations}/{plain.num_accepted_steps} with and without, "
              f"{shown.iterations} rows, ms/iter {1e3 * walls[True][0] / shown.iterations:.2f} shown, "
              f"{1e3 * walls[False][0] / plain.iterations:.2f} not; CheckAll passed, a wrong gradient raised "
              f"DerivError at [[0, 1]] [{card}]", flush=True)

        # (h) multistart, (i) the continuous engine in f32
        for name in ("(h) multistart", "(i) tame f32"):
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, _ = _precision_solve(name, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched(name, set())
            ref = pending[name].get(timeout=900)
            if name == "(h) multistart":
                dobj = abs(float(res.obj) - ref["obj"])
                check((res.best_index, res.num_optimal) == (ref["best"], ref["num_optimal"]) and dobj <= 1e-10,
                      f"{name}: best {res.best_index} obj {float(res.obj):.12e} optimal {res.num_optimal}, "
                      f"cpu {ref['best']} {ref['obj']:.12e} {ref['num_optimal']}")
                print(f"precision {name} B={MULTISTART_B}: best lane {res.best_index} obj {float(res.obj):.12e} "
                      f"(cpu equal, |dobj|={dobj:.1e}) optimal {res.num_optimal}/{MULTISTART_B} "
                      f"x={res.x.tolist()} wall={wall:.3f} s [{card}]", flush=True)
            else:
                counts = (res.iterations, res.num_integration_steps, res.num_newton_steps)
                dx = float(np.abs(res.x.cpu().numpy() - ref["x"]).max())
                equal = counts == tuple(ref["counts"])
                check(res.status.name == ref["status"] == "Optimal" and counts[0] == ref["counts"][0] and dx <= X_TOL
                      and res.x.dtype == torch.float32,
                      f"{name}: {res.status.name} {counts} x {res.x.dtype}, cpu {ref['status']} {ref['counts']}")
                if not equal:
                    parted.append((name, counts, tuple(ref["counts"]), dx))
                print(f"precision {name}: {res.status.name} {'/'.join(map(str, counts))} (cpu "
                      f"{'/'.join(map(str, ref['counts']))} {'equal' if equal else 'parted past the segments'}; "
                      f"JAX {'/'.join(map(str, JAX_TAME_F32))}) |x-x_cpu|={dx:.3e} wall={wall:.3f} s "
                      f"ms/step={1e3 * wall / counts[1]:.2f} [{card}]", flush=True)

    for label, ours, theirs, dx in parted:
        print(f"precision parted: {label} card {ours} cpu {theirs} |dx|={dx:.3e}", flush=True)
    print(f"precision launches: {totals}", flush=True)
    print(f"precision phase: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    if failures:
        fail("phase 11: " + "; ".join(failures))
    return totals


# phase 12: the multi-device frontends and the runners.  A device may repeat
# in a mesh, so the one card stands for a mesh of several; the results of
# phases 5, 6 and 10 are kept (REFERENCES) so that phase 12 holds the
# sharded runs against them, and it makes them itself when it runs alone.
REFERENCES = {}
BACKGROUND = []  # processes started in the background, stopped at exit
LONG_FIRST = "hs long first"
PHASE12_BUDGET_S = 240.0
SHARD_MESH = 4
SCHUR_NB, SCHUR_B, SCHUR_M = 512, 8, 1024
SCHUR_RTOL, SCHUR_ATOL = 1e-9, 1e-10  # tests/test_schur.py:57-95
# rows that may part in their counts, card against CPU: runs of at least
# 1,000 iterations, and the specs whose counts rounding parts between the
# packages (ROADMAP Queue C, "The HS sweep")
HS_PARTABLE = 1000
HS_PARTED = {"hs13", "hs18", "hs44", "hs62", "hs104", "hs106", "hs118"}
OBJ_RTOL = 1e-6
MPS_SAMPLE = """\
NAME          SAMPLE
ROWS
 N  COST
 L  LIM1
 G  LIM2
 E  EQ1
COLUMNS
    X1        COST      1.0        LIM1      1.0
    X1        LIM2      1.0
    X2        COST      2.0        LIM1      1.0
    X2        EQ1       1.0
    X3        COST      -1.0       EQ1       1.0
RHS
    RHS       LIM1      4.0        LIM2      1.0
    RHS       EQ1       7.0
BOUNDS
 UP BND       X1        4.0
 LO BND       X2        -1.0
ENDATA
"""


def _headline_starts():
    import numpy as np

    return np.random.default_rng(0).uniform(-1.5, 1.5, size=(HEADLINE_B, 2))


def _fleet_config():
    import numpy as np

    from pygradflow_torch import LinearSolverType, Params
    from pygradflow_torch.runners.control import PendulumControl

    params = Params(linear_solver_type=LinearSolverType.PallasLDLT, iteration_limit=3000, validate_input=False)
    problem = PendulumControl(N=FLEET_N)
    rng = np.random.default_rng(0)
    x0 = problem.x0_trajectory()[None, :] + 0.02 * rng.standard_normal((FLEET_B, problem.num_vars))
    return problem, params, x0


def _same_lanes(label, res, ref, fields=("status", "iterations", "accepted_steps", "x"), bits=True):
    """Every lane of ``res`` against ``ref``'s: bit for bit, or with
    ``bits`` false equal counts (all fields but the last) and x within
    X_TOL; returns whether x is bitwise equal and max |dx|."""
    import torch

    for field in fields[:-1] if not bits else fields:
        a, b = getattr(res, field), getattr(ref, field)
        if a.shape != b.shape or not torch.equal(a, b.to(a.device)):
            fail(f"{label}: {field} differs from the reference lanes")
    x, x_ref = getattr(res, fields[-1]), getattr(ref, fields[-1]).to(res.x.device)
    dx = float((x - x_ref).abs().max())
    if not dx <= X_TOL:
        fail(f"{label}: x differs from the reference lanes by {dx:.3e}")
    return torch.equal(x, x_ref), dx


def _distributed_rank(rank, world, port, out, lanes):
    """One rank of phase 12 (b): init_distributed on localhost, then
    DistributedSolver on the headline lanes, its full result saved."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from pygradflow_torch import Params
    from pygradflow_torch.parallel import DistributedSolver, init_distributed
    from tests.torch_parity import Rosenbrock

    info = init_distributed(coordinator_address=f"localhost:{port}", num_processes=world, process_id=rank)
    backend = torch.distributed.get_backend()
    res = DistributedSolver(Rosenbrock(), Params(validate_input=False, jit_chunk=128)).solve(
        torch.tensor(_headline_starts()[:lanes])
    )
    torch.cuda.synchronize()
    np.savez(out, backend=backend, global_devices=info.global_devices,
             **{f: getattr(res, f).cpu().numpy() for f in ("status", "iterations", "accepted_steps", "x")})
    torch.distributed.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(worlds, lanes, tmp, timeout=300.0):
    """Phase 12 (b): a process group of each size in ``worlds``, all
    spawned on the card at once, each on a port of its own; each group's
    per-rank results."""
    import multiprocessing

    import numpy as np

    ctx = multiprocessing.get_context("spawn")
    outs, procs = {}, []
    for world in worlds:
        port = _free_port()
        outs[world] = [os.path.join(tmp, f"rank{world}_{r}.npz") for r in range(world)]
        procs += [ctx.Process(target=_distributed_rank, args=(r, world, port, outs[world][r], lanes))
                  for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
            if p.exitcode != 0:
                fail(f"distributed: a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return {world: [dict(np.load(o)) for o in paths] for world, paths in outs.items()}


def _runner(module, args, out, device):
    """A runner sweep in a process of its own (a session of its own, so
    that its ``--parallel`` children stop with it); each child on one CPU
    thread, so that the children of the two sweeps share the host's cores.
    ``module`` names a runner of ``pygradflow_torch.runners``, or is
    ``LONG_FIRST``, the HS runner with hs104 and hs106 dispatched first
    (``tools/hs_long_first.py``)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    if module == LONG_FIRST:
        start = ["-c", "from tools.hs_long_first import LongFirstHSRunner; LongFirstHSRunner().main()"]
    else:
        start = ["-m", f"pygradflow_torch.runners.{module}"]
    cmd = [sys.executable, *start, *args, "--device", device, "--output", out]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                            start_new_session=True)
    BACKGROUND.append(proc)
    return proc


def start_hs_sweeps():
    """Phase 12 (e)'s two sweeps of the HS suite, started in the background
    once the kernels have been timed (the 80 children of ``--parallel 4``
    each need seconds to reach the card, and hs104 and hs106 run 10,000
    iterations each): ``--parallel 4`` on the card with those two
    dispatched first, and the port's CPU run in sequence, in one process,
    so that it takes one core of the host from the card's children; returns
    their processes, output directories and a record of their walls."""
    import tempfile
    import threading

    tmp = tempfile.mkdtemp(prefix="chip_smoke_hs_")
    sweeps = {"tmp": tmp, "walls": {}}
    for device, module, args in (("cuda", LONG_FIRST, ["--parallel", "4"]), ("cpu", "hs_runner", [])):
        out = os.path.join(tmp, device)
        t0 = time.perf_counter()
        proc = _runner(module, args, out, device)

        def wait(proc=proc, device=device, t0=t0):
            proc.wait()
            sweeps["walls"][device] = time.perf_counter() - t0

        threading.Thread(target=wait, daemon=True).start()
        sweeps[device] = (proc, out)
    print("multi (e) HS sweeps started in the background, on the card and on the CPU", flush=True)
    return sweeps


def stop_background():
    """Stop every process group that the script started in the background."""
    import signal

    while BACKGROUND:
        proc = BACKGROUND.pop()
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def _csv_rows(out):
    import csv

    with open(os.path.join(out, "output.csv")) as f:
        return {row["instance"]: row for row in csv.DictReader(f)}


def _hold_rows(label, ours, theirs, partable=None):
    """Runner rows on the card against the CPU run: equal statuses, and
    equal iterations and accepted steps with ``final_scaled_obj`` within
    OBJ_RTOL; a row that ``partable(name, row)`` admits may part in its
    counts, and keeps its status and objective.  Returns the parted rows."""
    if set(ours) != set(theirs):
        fail(f"{label}: instances {sorted(set(ours) ^ set(theirs))} in one run only")
    parted = []
    for name, row in ours.items():
        ref = theirs[name]
        obj, obj_ref = float(row["final_scaled_obj"]), float(ref["final_scaled_obj"])
        close = abs(obj - obj_ref) <= OBJ_RTOL * max(1.0, abs(obj_ref))
        counts = (row["iterations"], row["num_accepted_steps"])
        counts_ref = (ref["iterations"], ref["num_accepted_steps"])
        if counts != counts_ref and row["status"] != "optimal" and partable and partable(name, ref):
            # a parted run that did not converge ends at another iterate:
            # its objective is printed, not held
            close = True
        if row["status"] != ref["status"] or not close:
            fail(f"{label} {name}: {row['status']} {counts} obj {obj!r}, cpu {ref['status']} {counts_ref} {obj_ref!r}")
        if counts != counts_ref:
            if partable and partable(name, ref):
                parted.append((name, counts, counts_ref, abs(obj - obj_ref)))
            else:
                fail(f"{label} {name}: counts {counts}, cpu {counts_ref}")
    return parted


def multi_device_phase(card, sweeps=None):
    """Phase 12: ShardedSolver, DistributedSolver, distributed_schur_solve and
    ShardedIntegrationSolver on the card, and the HS, QP and MPS runners
    against the port's CPU runs; returns the launches of (a2).  ``sweeps``
    are the HS sweeps that ``start_hs_sweeps`` started (None: started
    here)."""
    import collections
    import tempfile

    import numpy as np
    import torch

    from pygradflow_torch import Params, SolverStatus
    from pygradflow_torch.integration import BatchedIntegrationSolver, ShardedIntegrationSolver
    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.native import available, parse_mps_native
    from pygradflow_torch.parallel import BatchedSolver, ShardedSolver
    from pygradflow_torch.parallel.schur import distributed_schur_solve
    from pygradflow_torch.runners.mps import parse_mps_py
    from pygradflow_torch.runners.mps_runner import MPSRunner
    from pygradflow_torch.runners.qp_runner import QPRunner
    from tests.torch_parity import Rosenbrock

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p12_")
    mps_dir = os.path.join(tmp, "mps")
    os.makedirs(mps_dir)
    with open(os.path.join(mps_dir, "sample.mps"), "w") as f:
        f.write(MPS_SAMPLE)
    if sweeps is None:
        sweeps = start_hs_sweeps()
    # the CPU runs of (f) start with the phase
    cpu_out = {k: os.path.join(tmp, f"cpu_{k}") for k in ("qp", "mps")}
    cpu_runs = {
        "qp": _runner("qp_runner", [], cpu_out["qp"], "cpu"),
        "mps": _runner("mps_runner", ["--dir", mps_dir], cpu_out["mps"], "cpu"),
    }

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    try:
        # (a) the headline sharded over one and over four shards of the card
        params = Params(validate_input=False, jit_chunk=128)
        x0 = torch.tensor(_headline_starts(), device="cuda")
        if "headline" not in REFERENCES:
            for _ in ("warm-up", "timed"):
                REFERENCES["headline"], REFERENCES["headline wall"] = timed(
                    lambda: BatchedSolver(Rosenbrock(), params, device="cuda").solve(x0))
            REFERENCES["headline plain"] = BatchedSolver(Rosenbrock(), params, device="cuda", compact=False).solve(x0)
        sharded = {}
        for shards in (1, SHARD_MESH):
            solver = ShardedSolver(Rosenbrock(), params, mesh=["cuda:0"] * shards)
            solver.solve(x0)  # warm-up, as the BatchedSolver run it is timed beside
            res, wall = timed(lambda: solver.solve(x0))
            _same_lanes(f"sharded headline ({shards} shard(s)) against BatchedSolver without compaction",
                        res, REFERENCES["headline plain"])
            _same_lanes(f"sharded headline ({shards} shard(s)) against BatchedSolver", res, REFERENCES["headline"])
            optimal = int((res.status == int(SolverStatus.Optimal)).sum())
            if optimal != HEADLINE_B:
                fail(f"sharded headline: {optimal}/{HEADLINE_B} Optimal")
            sharded[shards] = res
            print(f"multi (a) ShardedSolver headline B={HEADLINE_B} mesh cuda:0 x{shards}: {optimal}/{HEADLINE_B} "
                  f"Optimal, lanes bit for bit BatchedSolver's (with and without compaction), wall={wall:.3f} s "
                  f"solves/s={HEADLINE_B / wall:.1f} (BatchedSolver in this call "
                  f"{HEADLINE_B / REFERENCES['headline wall']:.1f}) [{card}]", flush=True)

        # (a2) the fleet, two shards of 64 lanes through B2'
        problem, fparams, fx0 = _fleet_config()
        fx0 = torch.tensor(fx0, device="cuda")
        if "fleet" not in REFERENCES:
            REFERENCES["fleet"] = BatchedSolver(problem, fparams, device="cuda").solve(fx0)
        solver = ShardedSolver(problem, fparams, mesh=["cuda:0"] * 2)
        for key in lk.LAUNCHES:
            lk.LAUNCHES[key] = 0
        res, wall = timed(lambda: solver.solve(fx0))
        used = dict(lk.LAUNCHES)
        # batched cuBLAS products pick their algorithms by batch count, so
        # the lanes' last bits may follow the width: counts must be equal,
        # x within X_TOL, and the bits are reported
        bitwise, dx = _same_lanes("sharded fleet against phase 5's BatchedSolver", res, REFERENCES["fleet"], bits=False)
        if used["rl_batched"] == 0 or used["rl"] or used["ll"]:
            fail(f"sharded fleet: launches {used}, expected only 'rl_batched'")
        iters = int(res.iterations.max())
        print(f"multi (a2) ShardedSolver fleet N={FLEET_N} B={FLEET_B} mesh cuda:0 x2: status and counts of phase 5's "
              f"lanes, x bitwise equal: {bitwise}, max |dx| {dx:.3e}, lockstep iterations {iters} (phase 5 "
              f"{int(REFERENCES['fleet'].iterations.max())}), launches {used} wall={wall:.3f} s [{card}]", flush=True)

        # (b) DistributedSolver: two ranks sharing the card over gloo, and
        # beside them one rank under NCCL
        groups, wall = timed(lambda: _run_ranks((2, 1), HEADLINE_B, tmp))
        for world, ranks in groups.items():
            for r, out in enumerate(ranks):
                expect = ("gloo", 2) if world == 2 else ("nccl", 1)
                if (str(out["backend"]), int(out["global_devices"])) != expect:
                    fail(f"distributed world {world} rank {r}: backend {out['backend']}, "
                         f"{out['global_devices']} devices, expected {expect}")
                for field in ("status", "iterations", "accepted_steps", "x"):
                    if not np.array_equal(out[field], getattr(sharded[1], field).cpu().numpy()):
                        fail(f"distributed world {world} rank {r}: {field} differs from (a)")
        print(f"multi (b) DistributedSolver: 2 ranks sharing the card over gloo and 1 rank under nccl, every rank "
              f"the full {HEADLINE_B} lanes of (a) bit for bit; wall with the ranks' start {wall:.3f} s [{card}]",
              flush=True)

        # (c) the distributed Schur solve against a dense f64 solve
        rng = np.random.default_rng(SEED)
        n = SCHUR_NB * SCHUR_B
        blocks = rng.standard_normal((SCHUR_NB, SCHUR_B, SCHUR_B))
        h = torch.tensor(blocks @ blocks.transpose(0, 2, 1) + SCHUR_B * np.eye(SCHUR_B), device="cuda")
        J = torch.tensor(rng.standard_normal((SCHUR_M, n)), device="cuda")
        m22 = -0.7 * torch.eye(SCHUR_M, dtype=torch.float64, device="cuda")
        rx = torch.tensor(rng.standard_normal(n), device="cuda")
        ry = torch.tensor(rng.standard_normal(SCHUR_M), device="cuda")
        (sx, sy), wall = timed(lambda: distributed_schur_solve(h, J, m22, rx, ry, mesh=["cuda:0"] * SHARD_MESH))
        K = torch.zeros((n + SCHUR_M, n + SCHUR_M), dtype=torch.float64, device="cuda")
        K[:n, :n] = torch.block_diag(*h)
        K[:n, n:], K[n:, :n], K[n:, n:] = J.T, J, m22
        dense, dense_wall = timed(lambda: torch.linalg.solve(K, torch.cat([rx, ry])))
        for label, ours, ref in (("sx", sx, dense[:n]), ("sy", sy, dense[n:])):
            err = (ours - ref).abs()
            if not bool((err <= SCHUR_ATOL + SCHUR_RTOL * ref.abs()).all()):
                fail(f"distributed Schur {label}: max |err| {float(err.max()):.3e}")
        rel = float(((torch.cat([sx, sy]) - dense).abs() / dense.abs().clamp_min(1e-300)).max())
        print(f"multi (c) distributed_schur_solve nb={SCHUR_NB} b={SCHUR_B} m={SCHUR_M} mesh cuda:0 x{SHARD_MESH}: "
              f"within rtol {SCHUR_RTOL} atol {SCHUR_ATOL} of the dense f64 solve (max rel {rel:.3e}), "
              f"wall {wall:.3f} s, dense {dense_wall:.3f} s [{card}]", flush=True)

        # (d) the continuous batch of phase 10 over four shards
        problem, iparams, x0s, y0s = _integ_batch(INTEG_B)
        x0s, y0s = torch.tensor(x0s, device="cuda"), torch.tensor(y0s, device="cuda")
        if "integ" not in REFERENCES:
            REFERENCES["integ"] = BatchedIntegrationSolver(problem, iparams, device="cuda").solve(x0s, y0s)
        solver = ShardedIntegrationSolver(problem, iparams, mesh=["cuda:0"] * SHARD_MESH)
        res, wall = timed(lambda: solver.solve(x0s, y0s))
        _same_lanes("sharded continuous batch against phase 10's", res, REFERENCES["integ"],
                    fields=("status", "iterations", "num_integration_steps", "num_newton_steps", "x", "y"))
        print(f"multi (d) ShardedIntegrationSolver B={INTEG_B} mesh cuda:0 x{SHARD_MESH}: lanes bit for bit phase "
              f"10's, units max {int(res.units.max())}, wall={wall:.3f} s solves/s={INTEG_B / wall:.1f} [{card}]",
              flush=True)

        # (e) the HS suite through the runner, four children on the card,
        # against the CPU run; both started in the background
        for device in ("cuda", "cpu"):
            proc, _ = sweeps[device]
            if proc.wait(timeout=1800) != 0:
                fail(f"multi (e) hs: the {device} sweep exited with {proc.returncode}")
        card_rows = _csv_rows(sweeps["cuda"][1])
        if len(card_rows) != 80:
            fail(f"multi (e) hs: {len(card_rows)} rows, expected 80")
        parted = _hold_rows("multi (e) hs", card_rows, _csv_rows(sweeps["cpu"][1]),
                            partable=lambda name, ref: name in HS_PARTED or int(ref["iterations"]) >= HS_PARTABLE)
        statuses = collections.Counter(row["status"] for row in card_rows.values())
        iterations = sum(int(row["iterations"]) for row in card_rows.values())
        longest = sorted(card_rows.values(), key=lambda row: -float(row["total_time"]))[:3]
        for name, ours, theirs, dobj in parted:
            print(f"multi (e) parted: {name} card {ours} cpu {theirs} |d obj| {dobj:.3e}", flush=True)
        print(f"multi (e) HSRunner --parallel 4 on the card: {len(card_rows)} rows {dict(statuses)}, "
              f"{iterations} iterations, every row held to the CPU run ({len(parted)} parted), wall "
              f"{sweeps['walls']['cuda']:.1f} s (the CPU run {sweeps['walls']['cpu']:.1f} s), longest "
              + ", ".join(f"{r['instance']} {float(r['total_time']):.1f} s "
                          f"({1e3 * float(r['total_time']) / max(1, int(r['iterations'])):.1f} ms/iteration)"
                          for r in longest)
              + f" [{card}]", flush=True)

        # (f) the QP runner in sequence on the card, then the MPS runner on
        # the inline file through the native reader
        if not available():
            fail("the native MPS reader did not build")
        path = os.path.join(mps_dir, "sample.mps")
        native, py = parse_mps_native(path), parse_mps_py(path)
        for key in ("c", "A", "cons_lb", "cons_ub", "var_lb", "var_ub"):
            if not np.array_equal(getattr(native, key), getattr(py, key)):
                fail(f"native MPS reader: {key} differs from parse_mps_py")
        for name, runner, args in (("qp", QPRunner(), []), ("mps", MPSRunner(), ["--dir", mps_dir])):
            out = os.path.join(tmp, f"card_{name}")
            t0 = time.perf_counter()
            runner.main(["--device", "cuda", "--output", out, *args])
            wall = time.perf_counter() - t0
            cpu_runs[name].wait(timeout=600)
            rows = _csv_rows(out)
            _hold_rows(f"multi (f) {name}", rows, _csv_rows(cpu_out[name]))
            summary = ", ".join(f"{k} {r['status']} {r['iterations']}/{r['num_accepted_steps']}" for k, r in rows.items())
            print(f"multi (f) {type(runner).__name__} on the card: {summary}, rows equal to the CPU run's, "
                  f"wall {wall:.1f} s [{card}]", flush=True)
    finally:
        stop_background()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(sweeps["tmp"], ignore_errors=True)

    elapsed = time.perf_counter() - t_phase
    within = "within" if elapsed <= PHASE12_BUDGET_S else "over"
    print(f"multi phase: {elapsed:.1f} s, {within} its budget of {PHASE12_BUDGET_S:.0f} s [{card}]", flush=True)
    return used


# phase 13: the public surface, the examples and the parity harness.  The
# examples run at the JAX examples' sizes; their CPU runs are made by
# worker processes started with the phase.  The harness's card subset runs
# in a process of its own, started with the HS sweeps: the HS specs and
# option cases whose JAX run took at most PARITY_MAX_IT iterations (the
# two Globalized option cases run 10,000 each and are held on the CPU
# only); its two pendulum cases run in the phase, so that their launches
# are counted.
EXAMPLES = {
    "solve_rosenbrock": {},
    "solve_constrained": {},
    "optimal_control": {"N": 64},
    "batched_sweep": {"B": 64},
    "continuous_flow": {"B": 8},
}
PARITY_MAX_IT = 200
PARITY_PENDULUM = {"pendulum N=128": "rl", "pendulum N=256": "ll"}
PERFORM_TOL = 1e-10


def _example_records(name, device):
    """Run the port's example ``name`` on ``device`` at its JAX size, its
    printing captured; returns [(label, record)] with status, counts and x
    as numpy, and the captured text."""
    import contextlib
    import importlib.util
    import io
    import logging

    import numpy as np

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    buf = io.StringIO()
    try:
        spec = importlib.util.spec_from_file_location(f"example_{name}", os.path.join(ROOT, "docs", "torch", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        with contextlib.redirect_stdout(buf):
            spec.loader.exec_module(mod)
            out = mod.main(device=device, **EXAMPLES[name])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                root.removeHandler(h)
        root.setLevel(level)

    def single(r):
        return dict(status=r.status.name, counts=(r.iterations, r.num_accepted_steps), x=r.x.cpu().numpy())

    def flow(r):
        return dict(status=r.status.name, counts=(r.iterations, r.num_integration_steps), x=r.x.cpu().numpy())

    def lanes(r, steps):
        return dict(status=r.status.tolist(), counts=(r.iterations.tolist(), getattr(r, steps).tolist()),
                    x=r.x.cpu().numpy())

    if name == "solve_rosenbrock":
        recs = [("Rosenbrock", single(out))]
    elif name == "solve_constrained":
        recs = [("HS71 display + checkpoint", single(out[0])), ("HS71 IntegrationSolver", flow(out[1]))]
    elif name == "optimal_control":
        recs = [("pendulum N=64 staged PallasLDLT", single(out))]
    elif name == "batched_sweep":
        if out[1] is not None:
            fail("batched_sweep: sharded on a machine with one card")
        recs = [("64 Rosenbrock lanes", lanes(out[0], "accepted_steps"))]
    else:
        recs = [("HS71 host TR-BDF2", flow(out[0])), ("HS71 device SDIRK4", flow(out[1])),
                ("8 HS71 lanes SDIRK4", lanes(out[2], "num_integration_steps"))]
    for label, rec in recs:
        if not np.isfinite(rec["x"]).all():
            fail(f"{name} {label}: x not finite")
    return recs, buf.getvalue()


def _example_reference(name):
    """The port's CPU run of the example ``name`` (in a worker process)."""
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    recs, _ = _example_records(name, "cpu")
    return recs, time.perf_counter() - t0


def _perform(problem, params, device, x0):
    """``Solver.perform_iteration`` on ``device``, the counters set to 0
    before it; returns (x, y, d) as numpy and the launches."""
    import torch

    from pygradflow_torch import Solver
    from pygradflow_torch.linalg import ldlt_kernels as lk

    for key in lk.LAUNCHES:
        lk.LAUNCHES[key] = 0
    x, y, d = Solver(problem, params, device=device).perform_iteration(torch.tensor(x0, device=device))
    if str(x.device).split(":")[0] != device:
        fail(f"perform_iteration returned a tensor on {x.device}, not {device}")
    return tuple(t.cpu().numpy() for t in (x, y, d)), dict(lk.LAUNCHES)


def start_parity_subset():
    """Phase 13 (c)'s harness process, started in the background: the HS
    and option cases of the card subset (the pendulum's run in the phase);
    returns the process and the directory of its log."""
    import tempfile

    from tools import torch_parity_cases as pc

    subset = [c.name for c in pc.cases() if c.kind in ("hs", "option")]
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_p13_")
    cmd = [sys.executable, os.path.join(ROOT, "tools", "torch_parity_check.py"), "--side", "torch", "--device",
           "cuda", "--max-iterations", str(PARITY_MAX_IT), "--cases", *subset]
    with open(os.path.join(log_dir, "parity.log"), "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
                                env=dict(os.environ, OMP_NUM_THREADS="1"))
    BACKGROUND.append(proc)
    return proc, log_dir


def surface_phase(card, parity=None):
    """Phase 13: (a) the five examples of docs/torch through their
    ``main(device="cuda")`` at the JAX examples' sizes, each against the
    port's CPU run (equal status and counts, x within X_TOL); (b)
    ``Solver.perform_iteration`` on Rosenbrock and on the pendulum at N=128
    on PallasLDLT (B1'), against the CPU to PERFORM_TOL; (c) the parity
    harness's card subset against ``tools/torch_parity_jax.json``, in the
    process ``parity`` that ``start_parity_subset`` started (None: started
    here).  Returns the launches of (a)-(c)."""
    import multiprocessing
    import re
    import shutil

    import numpy as np
    import torch

    from pygradflow_torch import Params
    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.runners.control import PendulumControl
    from tools import torch_parity_cases as pc
    from tools.torch_parity_check import load_jax_rows

    t_phase = time.perf_counter()
    totals = dict.fromkeys(("rl", "ll", "rl_batched"), 0)

    if parity is None:
        parity = start_parity_subset()

    with multiprocessing.get_context("spawn").Pool(3) as pool:
        pending = {name: pool.apply_async(_example_reference, (name,))
                   for name in ("continuous_flow", "solve_constrained", "optimal_control", "batched_sweep",
                                "solve_rosenbrock")}

        # (a) the examples on the card, in the JAX package's order
        for name in EXAMPLES:
            for key in lk.LAUNCHES:
                lk.LAUNCHES[key] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs, text = _example_records(name, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            used = dict(lk.LAUNCHES)
            for k in totals:
                totals[k] += used[k]
            refs, cpu_wall = pending[name].get(timeout=900)
            for (label, rec), (_, ref) in zip(recs, refs):
                if rec["status"] != ref["status"] or rec["counts"] != ref["counts"]:
                    fail(f"examples {name} {label}: {rec['status']} {rec['counts']}, cpu {ref['status']} {ref['counts']}")
                dx = float(np.abs(rec["x"] - ref["x"]).max())
                if not dx <= X_TOL:
                    fail(f"examples {name} {label}: x differs from the cpu run by {dx:.3e}")
                status = rec["status"] if isinstance(rec["status"], str) else f"{rec['status'].count(1)}/{len(rec['status'])} Optimal"
                counts = "/".join(str(c) if isinstance(c, int) else f"[{min(c)}..{max(c)}]" for c in rec["counts"])
                print(f"examples {name} {label}: {status} {counts}, equal to the cpu run, |x-x_cpu|={dx:.3e}", flush=True)
            last = [line for line in text.strip().splitlines() if line.strip()][-1:]
            print(f"examples {name}: launches={used} wall={wall:.3f} s (cpu run {cpu_wall:.1f} s); "
                  f"it printed {len(text.splitlines())} lines, the last: {last[0] if last else ''!r} [{card}]",
                  flush=True)

    # (b) perform_iteration against the CPU
    pend = PendulumControl(N=128)
    for label, problem, params, x0, key in (
        ("Rosenbrock Params()", pc.Rosenbrock(), Params(), np.zeros(2), None),
        ("pendulum N=128 PallasLDLT", pend, Params(**pc.PENDULUM_KWARGS), pend.x0_trajectory(), "rl"),
    ):
        ref, _ = _perform(problem, params, "cpu", x0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ours, used = _perform(problem, params, "cuda", x0)
        wall = time.perf_counter() - t0
        for k in totals:
            totals[k] += used[k]
        if key is not None and used[key] == 0:
            fail(f"perform_iteration {label}: launches {used}, {key} not launched")
        diffs = [float(np.abs(o - r).max()) if r.size else 0.0 for o, r in zip(ours, ref)]
        if not all(np.isfinite(o).all() and o.shape == r.shape for o, r in zip(ours, ref)) or max(diffs) > PERFORM_TOL:
            fail(f"perform_iteration {label}: |x, y, d - cpu| = {diffs}")
        print(f"perform_iteration {label}: (x, y, d) within {max(diffs):.3e} of the cpu, launches={used} "
              f"wall={wall:.3f} s [{card}]", flush=True)

    # (c) the pendulum cases here, then the harness's process
    rows = load_jax_rows()
    failed = []
    for name, key in PARITY_PENDULUM.items():
        for k in lk.LAUNCHES:
            lk.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        ours = pc.run_torch(name, "cuda")
        wall = time.perf_counter() - t0
        used = dict(lk.LAUNCHES)
        for k in totals:
            totals[k] += used[k]
        if used[key] == 0:
            fail(f"parity {name}: launches {used}, {key} not launched")
        verdict, details = pc.compare(ours, rows[name], "cuda")
        if verdict == "FAILED":
            failed.append(name)
        print(f"parity (c) {pc.format_line(name, verdict, details)} launches={used} wall={wall:.3f} s [{card}]",
              flush=True)
    harness, log_dir = parity
    t_wait = time.perf_counter()
    try:
        rc = harness.wait(timeout=900)
    finally:
        BACKGROUND.remove(harness)
    with open(os.path.join(log_dir, "parity.log")) as f:
        lines = [line.rstrip() for line in f if line.strip()]
    shutil.rmtree(log_dir, ignore_errors=True)
    for line in lines:
        print(f"parity (c) {line}", flush=True)
    if rc != 0 or failed:
        # the harness's verdicts and its traceback, if any, into the error itself
        faults = [line for line in lines if "FAILED" in line] or lines[-20:]
        fail(f"phase 13 (c): the harness exited {rc}, pendulum cases failed: {failed or 'none'}; "
             "the harness's log:\n" + "\n".join(faults))
    cases = sum(1 for line in lines if re.match(r"\s*(equal|parted as expected|FAILED)  ", line))
    print(f"parity (c) the harness's card subset: {cases} cases in its own process, waited for "
          f"{time.perf_counter() - t_wait:.1f} s [{card}]", flush=True)
    print(f"surface launches: {totals}", flush=True)
    print(f"surface phase: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return totals


# phase 14: the solve loop on the device.  Each configuration runs its
# solve through the graphed chunk (the route of Params on the card) and
# through the eager chunk (the loop's use_graphs set false; the loop's
# per-iteration read), in turns, from the same start: the two must give
# the same bits, the graphed solve one host read per chunk.
LOOP_CHUNK_N = 128  # the single pendulum of B1'; B3' at N=256
LOOP_OPTIONS = ["Full", "ActiveSet", "FixedActiveSet", "Globalized", "Exact", "ResiduumRatio", "Fixed",
                "Constant", "DualEquilibration", "ParetoDecrease", "ObjectiveFilter", "LagrangianFilter"]
LOOP_OPTION_IT = 60
LOOP_PROFILED = {"(a) rosenbrock", "(a) hs71", "(c) pendulum N=128", "(c) pendulum N=256", "(d) fleet", "(e) headline"}


def _loop_config(name):
    """Kind ("single", "lanes" or "mixed"), problem, params and starts of the
    phase 14 run ``name``."""
    import numpy as np

    import tests.torch_parity as tp
    from pygradflow_torch import LinearSolverType, Params
    from pygradflow_torch.runners.control import PendulumControl

    hs71 = (np.array([1.0, 5.0, 5.0, 1.0, 0.0]), np.zeros(2))
    pallas = dict(linear_solver_type=LinearSolverType.PallasLDLT, iteration_limit=3000, validate_input=False)
    if name == "(a) rosenbrock":
        return "single", tp.Rosenbrock(), Params(), (np.array([0.0, 0.0]), None)
    if name == "(a) hs71":
        return "single", tp.HS71(), Params(), hs71
    if name == "(b) hs71 LDLT":
        return "single", tp.HS71(), Params(linear_solver_type=LinearSolverType.LDLT), hs71
    if name == "(b) hs71 PallasLDLT":
        return "single", tp.HS71(), Params(linear_solver_type=LinearSolverType.PallasLDLT), hs71
    if name.startswith("(c) pendulum N="):
        problem = PendulumControl(N=int(name.split("=")[1]))
        return "single", problem, Params(**pallas), (problem.x0_trajectory(), None)
    if name == "(d) fleet":
        problem, params, x0 = _fleet_config()
        return "lanes", problem, params, (x0, None)
    if name == "(e) headline":
        return "lanes", tp.Rosenbrock(), Params(validate_input=False, jit_chunk=128), (_headline_starts(), None)
    if name == "(f) hs71 f32":
        return "single", tp.HS71(), Params(**SINGLE), hs71
    if name == "(f) mixed":
        return "mixed", tp.HS71(), Params(validate_input=False, jit_chunk=128), (_hs71_starts(1024), None)
    option = name.split()[-1]
    key = {"Exact": "step_control_type", "ResiduumRatio": "step_control_type", "Fixed": "step_control_type"}.get(option)
    if key is None:
        key = "newton_type" if option in ("Full", "ActiveSet", "FixedActiveSet", "Globalized") else "penalty_update"
    # at most LOOP_OPTION_IT iterations: Fixed, DualEquilibration and
    # Globalized take thousands on HS71
    return "single", tp.HS71(), Params(**{key: option}, iteration_limit=LOOP_OPTION_IT), hs71


LOOP_RUNS = (["(a) rosenbrock", "(a) hs71", "(b) hs71 LDLT", "(b) hs71 PallasLDLT",
              f"(c) pendulum N={LOOP_CHUNK_N}", "(c) pendulum N=256", "(d) fleet", "(e) headline",
              "(f) hs71 f32", "(f) mixed"] + [f"(g) hs71 {o}" for o in LOOP_OPTIONS])


def _loops(solver):
    """The solve loops of a Solver, a BatchedSolver or a
    MixedPrecisionSolver's two stages."""
    if hasattr(solver, "_loop"):
        return [solver._loop]
    if hasattr(solver, "loop"):
        return [solver.loop]
    return [solver.bulk.loop, solver.polish.loop]


def _make_eager(solver):
    """Send every chunk of ``solver`` through the eager loop."""
    for loop in _loops(solver):
        loop.use_graphs = False
    return solver


def _device_trace(fn):
    """``fn()`` under torch.profiler on the card: its result, the device's
    idle share over the traced span (1 - the union of kernel, copy and set
    intervals over the span from the first traced event to the last) and
    the count of kernels the device ran."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not device:
        return out, float("nan"), 0
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in device:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return out, 1.0 - busy / (end - start), kernels


def _loop_bits(label, kind, graphed, eager):
    """The graphed result against the eager one, bit for bit; returns the
    fields that differ."""
    import torch

    if kind == "single":
        pairs = [("x", graphed.x, eager.x), ("y", graphed.y, eager.y), ("d", graphed.d, eager.d)]
        scalars = ("status", "iterations", "num_accepted_steps", "num_penalty_changes", "final_stat_res",
                   "final_cons_violation", "dist_factor")
        differ = [f for f in scalars if getattr(graphed, f) != getattr(eager, f)]
        if graphed.num_evals != eager.num_evals:
            differ.append("num_evals")
    else:
        pairs = [(f, getattr(graphed, f), getattr(eager, f))
                 for f in ("x", "y", "d", "status", "iterations", "accepted_steps", "total_res", "stat_res")]
        pairs += [(f"counters.{k}", a, b) for k, a, b in zip(graphed.counters._fields, graphed.counters, eager.counters)]
        differ = []
    differ += [f for f, a, b in pairs if not torch.equal(a, b)]
    return differ


def loop_phase(card):
    """Phase 14: every configuration of ``LOOP_RUNS`` through the graphed
    and the eager chunk, in turns, on the card.  Holds their results bit for
    bit and the graphed solve to one host read per chunk (and a single
    solve to one more, of its start's verdicts); prints ms per
    iteration, captures, kernel launches per iteration, the ldlt wrappers'
    launches, and (for ``LOOP_PROFILED``) the device's idle share over a
    warm solve, for both routes.  Returns the ldlt launches of the graphed
    runs."""
    import math

    import torch

    from pygradflow_torch import Solver
    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.parallel import BatchedSolver, MixedPrecisionSolver
    from pygradflow_torch.util import CAPTURES, HOST_READS

    totals = dict.fromkeys(lk.LAUNCHES, 0)
    rows = {}
    for name in LOOP_RUNS:
        kind, problem, params, (x0, y0) = _loop_config(name)
        x0 = torch.tensor(x0, device="cuda")
        y0 = None if y0 is None else torch.tensor(y0, device="cuda")

        def make():
            if kind == "single":
                return Solver(problem, params, device="cuda")
            if kind == "lanes":
                return BatchedSolver(problem, params, device="cuda")
            return MixedPrecisionSolver(problem, params, device="cuda")

        solvers = {"graphed": make(), "eager": _make_eager(make())}
        record = {}
        results = {}
        for turn in range(2):  # first solves, then a warm turn
            for route, solver in solvers.items():
                lk.LAUNCHES.update(dict.fromkeys(lk.LAUNCHES, 0))
                HOST_READS.clear()
                captures = sum(loop.graph.captures for loop in _loops(solver))
                capture_ns = CAPTURES["ns"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solver.solve(x0, y0) if kind == "single" else solver.solve(x0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                iters = res.iterations if kind == "single" else int(res.iterations.max())
                if kind == "mixed":
                    iters += int(solver.bulk_result.iterations.max())
                new_captures = sum(loop.graph.captures for loop in _loops(solver)) - captures
                if route == "graphed" and turn > 0 and new_captures:
                    fail(f"loop {name}: a warm solve captured {new_captures} graphs")
                reads = dict(HOST_READS)
                if route == "graphed":
                    chunks = sum(math.ceil((iters + 1) / loop.params.jit_chunk) for loop in _loops(solver))
                    # a single solve's start graph reads its input check's verdicts once
                    starts = int(kind == "single" and solver.params.validate_input)
                    if (set(reads) - {"chunk", "start"} or reads.get("start", 0) != starts
                            or reads.get("chunk", 0) > chunks + 2 * len(_loops(solver))):
                        fail(f"loop {name}: host reads {reads} over {iters} iterations")
                entry = record.setdefault(route, dict(walls=[]))
                entry["walls"].append(wall)
                entry.update(iters=iters, reads=reads, launches=dict(lk.LAUNCHES))
                if turn == 0:
                    entry["first"] = wall
                    entry["captures"] = new_captures
                    entry["capture_s"] = (CAPTURES["ns"] - capture_ns) * 1e-9
                    for key in totals:
                        totals[key] += lk.LAUNCHES[key] if route == "graphed" else 0
                results[route] = res
        differ = _loop_bits(name, kind, results["graphed"], results["eager"])
        if differ:
            fail(f"loop {name}: graphed and eager differ in {differ}")
        if name in LOOP_PROFILED:
            for route, solver in solvers.items():
                torch.cuda.synchronize()
                _, idle, kernels = _device_trace(
                    lambda: solver.solve(x0, y0) if kind == "single" else solver.solve(x0))
                record[route].update(idle=idle, kernels=kernels)
        g, e = record["graphed"], record["eager"]
        for route, r in record.items():
            warm = r["walls"][1]
            line = (f"loop {name} [{route}]: {results[route].status.name if kind == 'single' else 'lanes'} "
                    f"iterations {r['iters']} ms/iter={1e3 * warm / r['iters']:.3f} (warm, first "
                    f"{r['first']:.3f} s) host reads {r['reads']} ldlt launches {r['launches']}")
            if route == "graphed":
                line += f" captures {r['captures']} in {r['capture_s']:.3f} s"
            if "idle" in r:
                line += (f" device idle {100 * r['idle']:.1f}% kernels/iter "
                         f"{r['kernels'] / r['iters']:.1f}")
            print(line + f" [{card}]", flush=True)
        print(f"loop {name}: graphed == eager bit for bit; eager/graphed wall "
              f"{e['walls'][1] / g['walls'][1]:.2f}x", flush=True)
        rows[name] = record

    # the headline's solves/s: a warm-up, then the minimum of 5, in turns
    kind, problem, params, (x0, _) = _loop_config("(e) headline")
    x0 = torch.tensor(x0, device="cuda")
    solvers = {"graphed": BatchedSolver(problem, params, device="cuda"),
               "eager": _make_eager(BatchedSolver(problem, params, device="cuda"))}
    for solver in solvers.values():
        solver.solve(x0)
    walls = {route: [] for route in solvers}
    for _ in range(5):
        for route, solver in solvers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.solve(x0)
            torch.cuda.synchronize()
            walls[route].append(time.perf_counter() - t0)
    for route, w in walls.items():
        print(f"loop headline solves/s [{route}]: {HEADLINE_B / min(w):.1f} (min of 5 after a warm-up; "
              f"walls {min(w):.4f}-{max(w):.4f} s, spread {100 * (max(w) / min(w) - 1):.1f}%) [{card}]",
              flush=True)
    return totals


def host_reading_problem_check():
    """A problem whose objective branches on a tensor on the host cannot be
    captured: the card solve raises, naming the objective.  The process
    goes on solving as a CUDA graph after it: HS71 solved before and after
    gives the same bits.  A problem that declares ``evaluates_on_host``
    (``--debug_nans``'s checked HS71) takes the eager loop, to the same
    bits."""
    import numpy as np
    import torch

    from pygradflow_torch import Params, Problem, Solver
    from pygradflow_torch.runners.hs import HS_BY_NAME
    from pygradflow_torch.runners.hs_runner import HSInstance
    from pygradflow_torch.graphs import GraphCaptureError

    class Branching(Problem):
        def __init__(self):
            super().__init__(np.full(2, -np.inf), np.full(2, np.inf))

        def obj(self, x):
            return torch.dot(x, x) if bool(x[0] > 0) else torch.dot(x, x) + 1.0

    hs71 = HSInstance(HS_BY_NAME["hs71"])

    def solve_hs71(**kwargs):
        res = hs71.solve(Params(), "cuda", **kwargs)
        return res, torch.cat([res.x, res.y, res.d]).cpu()

    before, bits = solve_hs71()
    try:
        Solver(Branching(), Params(validate_input=False), device="cuda").solve(np.array([1.0, 1.0]))
    except GraphCaptureError as err:
        if "objective" not in str(err):
            fail(f"host-reading problem: the error does not name the objective: {err}")
        print(f"loop: a problem that reads the host raises: {str(err)[:120]}", flush=True)
    else:
        fail("host-reading problem: the card solve did not raise")
    for label, kwargs in (("graphed after the failed capture", {}), ("--debug_nans (eager)", {"debug_nans": True})):
        res, again = solve_hs71(**kwargs)
        same = torch.equal(again, bits) and (res.status, res.iterations) == (before.status, before.iterations)
        if not same:
            fail(f"hs71 {label}: {res.status.name} {res.iterations} iterations, "
                 f"not the bits of the solve before ({before.status.name} {before.iterations})")
        print(f"loop: hs71 {label}: {'same bits' if same else 'PARTED'}, {res.iterations} iterations", flush=True)


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
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    if sys.argv[1:] == ["--only", "10"]:  # the continuous engine alone, no kernel
        continuous_phase(card)
        print(json.dumps({"ok": True, "device": device}))
        return 0
    build_phase()
    if sys.argv[1:] == ["--only", "11"]:  # the precision phase alone, after the build
        precision_phase(card)
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if sys.argv[1:] == ["--only", "13"]:  # the surface phase alone, after the build
        try:
            surface_phase(card)
        finally:
            stop_background()
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if sys.argv[1:] == ["--only", "14"]:  # the solve loop on the device alone, after the build
        loop_phase(card)
        host_reading_problem_check()
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if sys.argv[1:] == ["--only", "12"]:  # the multi-device phase alone, after the build
        try:
            multi_device_phase(card)
        finally:
            stop_background()
        print(json.dumps({"ok": True, "device": device}))
        return 0
    t_run = time.perf_counter()
    walls = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        print(f"phase {name}: {walls[name]:.1f} s (script at {time.perf_counter() - t_run:.1f} s)", flush=True)
        return out

    try:
        path = path_matrices("cuda")
        records = phase("3 kernels", kernel_phase, card, path)
        two_level_phase(card, path)
        records["rl_batched"] = phase("3 batched kernel", batched_kernel_phase, card, path)
        phase("3 split", split_phase, card)
        # phase 14 on a quiet card, before the background processes start
        launches = phase("14 loop", loop_phase, card)
        sweeps = start_hs_sweeps()  # phase 12 (e), beside phases 4-11
        parity = start_parity_subset()  # phase 13 (c), beside them too
        for key, count in phase("4 slice", slice_phase, card).items():
            launches[key] += count
        launches["rl_batched"] += phase("5 fleet", fleet_phase, card)["rl_batched"]
        phase("6 headline", headline_phase, card)
        for key, count in phase("7 control", control_phase, card).items():
            launches[key] += count
        options_launches, qp_case = phase("8 options", options_phase, card)
        for key, count in options_launches.items():
            launches[key] += count
        records["rl"]["cases"].append(qp_case)
        for key, count in phase("9 last options", last_options_phase, card).items():
            launches[key] += count
        phase("10 continuous", continuous_phase, card)
        for key, count in phase("11 precision", precision_phase, card).items():
            launches[key] += count
        # phase 13 before phase 12: it overlaps the HS sweeps that phase 12 waits for
        for key, count in phase("13 surface", surface_phase, card, parity).items():
            launches[key] += count
        for key, count in phase("12 multi-device", multi_device_phase, card, sweeps).items():
            launches[key] += count
        host_reading_problem_check()
    finally:
        stop_background()

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
    print(json.dumps({"ok": True, "device": device}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
