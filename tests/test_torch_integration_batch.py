"""The port's ``BatchedIntegrationSolver`` (the flat engine over a lane
stack) against the JAX package's, lane by lane, and against the port's own
single flat solves, on the CPU."""

import functools

import numpy as np
import pytest
import torch

import pygradflow_tpu
import pygradflow_tpu.integration
from pygradflow_torch import IntegrationMethod, Params, SolverStatus
from pygradflow_torch.integration import BatchedIntegrationSolver, IntegrationSolver
from tests import problems

from .torch_parity import HS71Explicit, TameExplicit, numpy, tensor

X_TOL = 1e-8
BASE = dict(iteration_limit=1000, rho=1e-2)


def _nudged(x0s, lane, j, ulps):
    """Row ``lane`` of ``x0s`` with ``x0s[lane, j]`` moved by ``ulps`` ulps."""
    x0 = x0s[lane].copy()
    for _ in range(abs(ulps)):
        x0[j] = np.nextafter(x0[j], np.inf if ulps > 0 else -np.inf)
    return x0


def _four_starts():
    """The four HS71 lanes of ``tests/test_integration_batch.py:37-55``."""
    inst = problems.hs71_instance()
    x0s = np.tile(inst.x_0, (4, 1))
    x0s[1, 1] = 4.5
    x0s[2, 2] = 4.0
    x0s[3, 0] = 2.0
    return x0s, np.tile(inst.y_0, (4, 1))


def _bench_starts(B=8):
    """The first B of ``benchmarks/bench_integration_batch.py``'s perturbed
    HS71 starts."""
    rng = np.random.default_rng(7)
    lo, hi = np.array([1.0, 1.0, 1.0, 1.0, 0.0]), np.array([5.0, 5.0, 5.0, 5.0, 2.0])
    return np.clip(problems.hs71_instance().x_0[None, :] + rng.uniform(-0.1, 0.1, size=(B, 5)), lo, hi)


# The counts of a lane hang on event decisions that a last-bit difference
# can flip, and the JAX package's own lanes part within a few ulps of their
# starts.  Where the port's lane parts from JAX's, the JAX package's run from
# a start a few ulps away takes the port's trajectory: (lane, coordinate,
# ulps) of that start.
FOUR_NUDGES = [(2, 1, -6)]
BENCH_NUDGES = [(0, 1, -1), (4, 0, 1), (5, 2, -1), (7, 3, -1)]
BENCH = dict(BASE, integration_max_steps=50_000)


@functools.lru_cache(maxsize=None)
def _jax_batch(name):
    """The JAX package's lanes: the nominal starts, then the nudged ones."""
    params = pygradflow_tpu.Params(**BASE)
    if name == "hs71":
        x0s, _ = _four_starts()
        x0s = np.concatenate([x0s, [_nudged(x0s, *n) for n in FOUR_NUDGES]])
        problem = problems.HS71()
    elif name == "bench":
        x0s = _bench_starts()
        x0s = np.concatenate([x0s, [_nudged(x0s, *n) for n in BENCH_NUDGES]])
        problem = problems.HS71()
        params = pygradflow_tpu.Params(**BENCH, integration_method=pygradflow_tpu.IntegrationMethod.SDIRK4)
    else:
        inst = problems.tame_instance()
        x0s, problem = np.tile(inst.x_0, (2, 1)), problems.Tame()
    y0s = np.zeros((len(x0s), problem.num_cons))
    return pygradflow_tpu.integration.BatchedIntegrationSolver(problem, params).solve(x0s, y0s)


def _lanes(res):
    return [
        (SolverStatus(int(s)).name, int(i), int(k), int(n))
        for s, i, k, n in zip(
            np.asarray(res.status), np.asarray(res.iterations),
            np.asarray(res.num_integration_steps), np.asarray(res.num_newton_steps),
        )
    ]


def _assert_lanes_match(ours, ref, nudges):
    """Each of the port's lanes equals the JAX package's lane from the same
    start, or for a nudged lane from its nudged start (appended to ``ref``
    in the order of ``nudges``): equal counts, x and y within X_TOL."""
    B = len(_lanes(ours))
    match = list(range(B))
    for k, (lane, _, _) in enumerate(nudges):
        match[lane] = B + k
    jax_lanes, our_lanes = _lanes(ref), _lanes(ours)
    assert our_lanes == [jax_lanes[k] for k in match]
    np.testing.assert_allclose(numpy(ours.x), np.asarray(ref.x)[match], rtol=0, atol=X_TOL)
    np.testing.assert_allclose(numpy(ours.y), np.asarray(ref.y)[match], rtol=0, atol=X_TOL)
    return jax_lanes[:B]


def test_hs71_lanes_match_jax():
    """Lanes 0, 1 and 3 take JAX's steps; lane 2 takes the trajectory of
    JAX's lane from x0[1] six ulps below 5 (ROADMAP Queue C)."""
    ref = _jax_batch("hs71")
    x0s, y0s = _four_starts()
    ours = BatchedIntegrationSolver(HS71Explicit(), Params(**BASE), device="cpu").solve(tensor(x0s), tensor(y0s))
    assert _assert_lanes_match(ours, ref, FOUR_NUDGES) == [
        ("Optimal", 10, 357, 1785), ("Optimal", 9, 262, 1318), ("Optimal", 13, 321, 1454), ("Optimal", 5, 297, 1472),
    ]


def test_bench_lanes_match_jax():
    """Lanes 0-7 of the bench configuration (SDIRK4) in chunks of 64 work
    units: lanes 1, 2, 3 and 6 take JAX's steps, lanes 0, 4, 5 and 7 the
    trajectories of JAX's lanes from starts one ulp away (ROADMAP Queue C)."""
    ref = _jax_batch("bench")
    params = Params(**BENCH, integration_method=IntegrationMethod.SDIRK4, integration_chunk=64)
    ours = BatchedIntegrationSolver(HS71Explicit(), params, device="cpu").solve(tensor(_bench_starts()))
    jax_nominal = _assert_lanes_match(ours, ref, BENCH_NUDGES)
    assert [counts[1:3] for counts in jax_nominal] == [
        (11, 194), (12, 192), (10, 186), (12, 204), (10, 191), (13, 205), (10, 186), (12, 198)
    ]


def test_tame_lanes_match_jax():
    ref = _jax_batch("tame")
    inst = problems.tame_instance()
    ours = BatchedIntegrationSolver(TameExplicit(), Params(**BASE), device="cpu").solve(
        tensor(np.tile(inst.x_0, (2, 1))), tensor(np.tile(inst.y_0, (2, 1)))
    )
    assert _lanes(ours) == _lanes(ref) == [("Optimal", 12, 684, 2697)] * 2
    np.testing.assert_allclose(numpy(ours.x), np.asarray(ref.x), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(numpy(ours.x), np.tile(inst.x_opt, (2, 1)), atol=1e-8)


def test_compaction_keeps_lane_order_and_single_solves():
    """Six perturbed HS71 lanes in chunks of 64 work units: many harvests
    and tier repacks (``tests/test_integration_batch.py:125-140``).  Each
    lane equals the port's single flat solve of its start bit for bit."""
    inst = problems.hs71_instance()
    rng = np.random.default_rng(3)
    x0s = np.stack([inst.x_0 + rng.uniform(-0.05, 0.05, size=inst.x_0.shape) for _ in range(6)])
    params = Params(**BASE, integration_chunk=64)
    solver = BatchedIntegrationSolver(HS71Explicit(), params, device="cpu")
    res = solver.solve(tensor(x0s))
    assert res.success.all()
    assert len(set(res.num_integration_steps.tolist())) > 1
    assert len(solver.tiers) > 1 and min(solver.tiers) == 8
    single = IntegrationSolver(
        HS71Explicit(), Params(**BASE, integration_device_loop=True, time_limit=9000.0), device="cpu"
    )
    for k, x0 in enumerate(x0s):
        ref = single.solve(tensor(x0), torch.zeros(2, dtype=torch.float64))
        counts = (ref.status.name, ref.iterations, ref.num_integration_steps, ref.num_newton_steps)
        assert _lanes(res)[k] == counts
        assert int(res.units[k]) == ref.num_work_units
        assert torch.equal(res.x[k], ref.x) and torch.equal(res.y[k], ref.y)
    np.testing.assert_allclose(numpy(res.x), np.tile(inst.x_opt, (6, 1)), atol=1e-6)


def test_batched_iteration_limit_matches_jax():
    inst = problems.hs71_instance()
    ref = pygradflow_tpu.integration.BatchedIntegrationSolver(
        problems.HS71(), pygradflow_tpu.Params(iteration_limit=2, rho=1e-2)
    ).solve(inst.x_0[None, :], inst.y_0[None, :])
    ours = BatchedIntegrationSolver(HS71Explicit(), Params(iteration_limit=2, rho=1e-2), device="cpu").solve(
        tensor(inst.x_0[None, :]), tensor(inst.y_0[None, :])
    )
    assert _lanes(ours) == _lanes(ref) == [("IterationLimit", 2, 127, 640)]


def test_batched_time_limit():
    inst = problems.hs71_instance()
    params = Params(**BASE, time_limit=1e-9, integration_chunk=8)
    x0s = np.stack([inst.x_0, inst.x_0 + 0.01])
    res = BatchedIntegrationSolver(HS71Explicit(), params, device="cpu").solve(tensor(x0s))
    assert (res.status == int(SolverStatus.TimeLimit)).all()
    assert (res.units == 8).all()


def test_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (IntegrationSolver, BatchedIntegrationSolver):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(HS71Explicit(), Params())
        assert cls(HS71Explicit(), Params(), device="cpu").device.type == "cpu"

