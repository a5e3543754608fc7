"""The port's solve loop on the device (``SolveLoop.body``/``run_chunks``,
``LaneLoop.body``/``read``) on the CPU: the same tensor body that the card
replays as a CUDA graph, run eagerly, with one host read per chunk of
``params.jit_chunk`` iterations.

The loop state's scalars are 0-dim tensors of ``params.dtype`` on the
solver's device; the body makes no host read (checked with a dispatch mode
that sees every ``.item()``, ``bool()`` and ``float()`` of a tensor); the
chunk length does not change a bit of the result; a terminal state passes
through extra bodies unchanged; and statuses, counts and x, y agree with
the JAX package's live run to 1e-8 (1e-6 through the mixed-precision
LDL^T tier).
"""

import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import pygradflow_torch
import pygradflow_tpu
import tests.problems as jprob
from pygradflow_torch.callbacks import CallbackType
from pygradflow_torch.graphs import LOOKAHEAD, replay_until_done
from pygradflow_torch.parallel import BatchedSolver
from pygradflow_torch.runners.control import PendulumControl as TPendulum
from pygradflow_torch.solver import graph_route
from pygradflow_torch.status import RUNNING, SolverStatus
from pygradflow_torch.util import HOST_READS, tree_map
from pygradflow_tpu.parallel import BatchedSolver as JBatchedSolver
from pygradflow_tpu.runners.control import PendulumControl as JPendulum

from . import torch_parity as tprob
from .test_cutest import fake_pycutest  # noqa: F401 (fixture)
from .torch_parity import ANCHOR, F64_TOL, PALLAS_TOL, assert_same_solve, numpy, params_pair, tensor

HS71_X0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])


def _case(name):
    """(JAX problem, port problem, x0, y0, Params kwargs, tolerance)."""
    if name == "rosenbrock":
        return jprob.Rosenbrock(), tprob.Rosenbrock(), np.array([0.0, 0.0]), None, {}, F64_TOL
    if name == "hs71":
        return jprob.HS71(), tprob.HS71(), HS71_X0, np.zeros(2), {}, F64_TOL
    if name == "pendulum":
        x0 = JPendulum(N=8).x0_trajectory()
        return JPendulum(N=8), TPendulum(N=8), x0, None, dict(ANCHOR), PALLAS_TOL
    raise ValueError(name)


CASES = ["rosenbrock", "hs71", "pendulum"]


class _HostReads(TorchDispatchMode):
    """Counts the ops that read a tensor's value on the host."""

    def __init__(self):
        super().__init__()
        self.reads = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _solve(name, **overrides):
    jp, tp, x0, y0, kwargs, _ = _case(name)
    params = params_pair(**dict(kwargs, **overrides))[1]
    solver = pygradflow_torch.Solver(tp, params, device="cpu")
    return solver, solver.solve(tensor(x0), None if y0 is None else tensor(y0))


@pytest.mark.parametrize("name", CASES)
def test_solver_reads_the_host_once_per_chunk(name):
    """At ``Params()`` defaults (the pendulum under PallasLDLT, the plain
    factor) the loop reads the host once per chunk and nowhere else; the
    counts and x, y equal the JAX package's live run."""
    jp, tp, x0, y0, kwargs, tol = _case(name)
    HOST_READS.clear()
    solver, tr = _solve(name, jit_chunk=7)
    assert set(HOST_READS) == {"chunk"}
    assert HOST_READS["chunk"] <= math.ceil(tr.iterations / 7) + 1
    jr = pygradflow_tpu.Solver(jp, params_pair(**dict(kwargs, jit_chunk=7))[0]).solve(x0, y0)
    assert_same_solve(tr, jr, tol)


@pytest.mark.parametrize("name", CASES)
def test_batched_solver_reads_the_host_once_per_chunk(name):
    """Three lanes of the case, a few ulps apart, in lockstep: one read of
    the status vector per chunk; each lane equals the JAX package's
    BatchedSolver."""
    jp, tp, x0, y0, kwargs, tol = _case(name)
    rng = np.random.default_rng(5)
    x0s = x0 + 1e-3 * rng.standard_normal((3, x0.shape[0])) * (name != "hs71")
    y0s = None if y0 is None else np.tile(y0, (3, 1))
    jparams, params = params_pair(**dict(kwargs, jit_chunk=7))
    HOST_READS.clear()
    tr = BatchedSolver(tp, params, device="cpu").solve(x0s, y0s)
    assert set(HOST_READS) == {"chunk"}
    assert HOST_READS["chunk"] <= math.ceil(int(tr.iterations.max()) / 7) + 1
    jr = JBatchedSolver(jp, jparams).solve(x0s, y0s)
    assert numpy(tr.status).tolist() == np.asarray(jr.status).tolist()
    assert numpy(tr.iterations).tolist() == np.asarray(jr.iterations).tolist()
    assert numpy(tr.accepted_steps).tolist() == np.asarray(jr.accepted_steps).tolist()
    np.testing.assert_allclose(numpy(tr.x), np.asarray(jr.x), rtol=0, atol=tol)
    np.testing.assert_allclose(numpy(tr.y), np.asarray(jr.y), rtol=0, atol=tol)


@pytest.mark.parametrize("name", CASES)
def test_chunk_length_changes_no_bit(name):
    """``jit_chunk`` 1, 7 and 64 give the same x, y, status and counts bit
    for bit, single and lockstep."""
    results = [_solve(name, jit_chunk=k)[1] for k in (1, 7, 64)]
    for r in results[1:]:
        assert (r.status, r.iterations, r.num_accepted_steps) == (
            results[0].status, results[0].iterations, results[0].num_accepted_steps,
        )
        assert r.num_evals == results[0].num_evals
        assert torch.equal(r.x, results[0].x) and torch.equal(r.y, results[0].y)

    _, tp, x0, y0, kwargs, _ = _case(name)
    x0s = np.tile(x0, (2, 1))
    y0s = None if y0 is None else np.tile(y0, (2, 1))
    lanes = [
        BatchedSolver(tp, params_pair(**dict(kwargs, jit_chunk=k))[1], device="cpu").solve(x0s, y0s)
        for k in (1, 7, 64)
    ]
    for r in lanes[1:]:
        for field in ("x", "y", "status", "iterations", "accepted_steps"):
            assert torch.equal(getattr(r, field), getattr(lanes[0], field))


@pytest.mark.parametrize("name", CASES)
def test_body_reads_nothing_and_keeps_a_terminal_state(name):
    """The single and the lockstep body make no host read; a state whose
    status is terminal comes out of further bodies bit for bit."""
    solver, _ = _solve(name)
    loop = solver._loop
    _, _, x0, y0, _, _ = _case(name)
    x, y = solver.transform.create_transformed_initial(tensor(x0), None if y0 is None else tensor(y0), solver.device)
    state = loop.init_state(x, y)
    with _HostReads() as mode:
        after = loop.body(state)
    assert not mode.reads
    assert int(after.iteration) == 1

    done = loop.run_chunks(x, y, pygradflow_torch.timer.Timer(np.inf))[0]
    assert int(done.status) != RUNNING
    again = loop.body(loop.body(done))
    for a, b in zip(torch.utils._pytree.tree_leaves(done), torch.utils._pytree.tree_leaves(again)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)

    lanes = BatchedSolver(solver.orig_problem, solver.params, device="cpu").loop
    xs, ys = torch.stack([x, x]), torch.stack([y, y])
    lane_state = lanes.init_state(xs, ys)
    with _HostReads() as mode:
        lanes.body(lane_state)
    assert not mode.reads


@pytest.mark.parametrize("name", CASES)
def test_check_terminate_on_lanes_equals_each_lane(name):
    """One ``check_terminate`` (``solver.ChunkLoop``'s) gives a lane stack
    the statuses it gives each lane's 0-dim state: the lockstep states from
    the start to the optimum, and one lane at the iteration limit."""
    solver, result = _solve(name)
    _, _, x0, y0, _, _ = _case(name)
    x, y = solver.transform.create_transformed_initial(tensor(x0), None if y0 is None else tensor(y0), solver.device)
    lanes = BatchedSolver(solver.orig_problem, solver.params, device="cpu").loop
    state = lanes.init_state(x[None], y[None])
    states = [state]
    for _ in range(result.iterations):
        state = lanes.body(state)
        states.append(state)
    stack = tree_map(lambda *a: torch.cat(a), *states)
    width = stack.status.shape[0]
    stack = stack._replace(iteration=torch.where(torch.arange(width) == 1, lanes.iteration_limit, stack.iteration))
    statuses = lanes.check_terminate(stack).tolist()
    single = [int(solver._loop.check_terminate(tree_map(lambda a: a[k], stack))) for k in range(width)]
    assert statuses == single
    assert {RUNNING, int(SolverStatus.Optimal), int(SolverStatus.IterationLimit)} <= set(single)


@pytest.mark.parametrize("precision", ["Double", "Single"])
def test_loop_scalars_are_device_tensors(precision):
    """lamb, rho, error_sum, path_dist and rcond are 0-dim tensors of
    ``params.dtype``, the counts and the status 0-dim int64 tensors, on the
    solver's device; the ``eval_fail`` flag a 0-dim bool tensor."""
    params = pygradflow_torch.Params(precision=getattr(pygradflow_torch.Precision, precision))
    solver = pygradflow_torch.Solver(tprob.HS71(), params, device="cpu")
    x, y = solver.transform.create_transformed_initial(tensor(HS71_X0), tensor(np.zeros(2)), solver.device)
    state = solver._loop.body(solver._loop.init_state(x, y))
    for name in ("lamb", "rho", "error_sum", "path_dist", "rcond"):
        value = getattr(state, name)
        assert torch.is_tensor(value) and value.ndim == 0, name
        assert value.dtype == params.dtype and value.device == solver.device, name
    for value in (state.iteration, state.accepted_steps, state.num_penalty_changes, state.status, *state.counters):
        assert torch.is_tensor(value) and value.ndim == 0 and value.dtype == torch.int64
    assert state.eval_fail[0].dtype == torch.bool and state.eval_fail[0].ndim == 0


def test_iteration_and_time_limits_as_in_jax():
    """IterationLimit after exactly the limit, and TimeLimit at the first
    chunk boundary, as the JAX package ends them."""
    jp, tp, x0, y0, kwargs, _ = _case("hs71")
    for overrides, status, iterations in (
        (dict(iteration_limit=5, jit_chunk=3), "IterationLimit", 5),
        (dict(time_limit=1e-9, jit_chunk=4), "TimeLimit", 4),
    ):
        jparams, params = params_pair(**overrides)
        jr = pygradflow_tpu.Solver(jp, jparams).solve(x0, y0)
        tr = pygradflow_torch.Solver(tp, params, device="cpu").solve(tensor(x0), tensor(y0))
        assert (tr.status.name, tr.iterations) == (jr.status.name, jr.iterations) == (status, iterations)
        np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=F64_TOL)

        tb = BatchedSolver(tp, params, device="cpu").solve(np.tile(x0, (2, 1)), np.tile(y0, (2, 1)))
        jb = JBatchedSolver(jp, jparams).solve(np.tile(x0, (2, 1)), np.tile(y0, (2, 1)))
        assert numpy(tb.status).tolist() == np.asarray(jb.status).tolist()
        assert numpy(tb.iterations).tolist() == np.asarray(jb.iterations).tolist()


def test_lambda_limit_as_in_jax():
    """A lambda past ``lamb_max`` (below every lambda the first step can
    give): the single solve raises the reference's error, the lockstep
    solve reports the status after the JAX package's iteration count."""
    jp, tp, x0, y0, _, _ = _case("hs71")
    jparams, params = params_pair(lamb_max=1e-3, jit_chunk=3)
    with pytest.raises(Exception, match=r"exceeded maximum 0.001 \(incorrect derivatives\?\)"):
        pygradflow_tpu.Solver(jp, jparams).solve(x0, y0)
    with pytest.raises(Exception, match=r"exceeded maximum 0.001 \(incorrect derivatives\?\)"):
        pygradflow_torch.Solver(tp, params, device="cpu").solve(tensor(x0), tensor(y0))
    tb = BatchedSolver(tp, params, device="cpu").solve(np.tile(x0, (2, 1)), np.tile(y0, (2, 1)))
    jb = JBatchedSolver(jp, jparams).solve(np.tile(x0, (2, 1)), np.tile(y0, (2, 1)))
    assert numpy(tb.status).tolist() == np.asarray(jb.status).tolist() == [6, 6]
    assert numpy(tb.iterations).tolist() == np.asarray(jb.iterations).tolist()


def test_route_is_decided_from_params():
    """The graphed chunk serves the defaults, the LDL^T tiers, single
    precision, every Newton type and the host-free controls; display,
    callbacks, BoxReduced, Optimizing, MINRES, GMRES and the problems that
    evaluate on the host keep the eager loop, each with its reason."""
    P = pygradflow_torch.Params
    E = pygradflow_torch.params
    graphed = [
        P(),
        P(linear_solver_type=E.LinearSolverType.LDLT),
        P(linear_solver_type=E.LinearSolverType.PallasLDLT),
        P(precision=E.Precision.Single),
        P(newton_type=E.NewtonType.Globalized, step_control_type=E.StepControlType.Exact),
        P(penalty_update=E.PenaltyUpdate.LagrangianFilter, collect_path=True, report_rcond=True),
    ]
    assert all(graph_route(p) is None for p in graphed)
    eager = [
        P(display=True),
        P(step_control_type=E.StepControlType.BoxReduced),
        P(step_control_type=E.StepControlType.Optimizing),
        P(linear_solver_type=E.LinearSolverType.MINRES),
        P(linear_solver_type=E.LinearSolverType.GMRES),
    ]
    assert all(graph_route(p) for p in eager)
    solver = pygradflow_torch.Solver(tprob.Rosenbrock(), P(), device="cpu")
    loop = solver._loop
    loop.use_graphs = True  # the card's decision, without a card
    assert loop.decide_route()
    # a callback registered after construction sends the next solve down
    # the eager route, decided at the solve's start
    solver.callbacks.register(CallbackType.ComputedStep, lambda *a: None)
    assert "ComputedStep" in graph_route(solver.params, solver.callbacks)
    assert solver.solve(np.array([0.0, 0.0])).status.name == "Optimal" and not loop.graphed
    # on the CPU both routes run the eager chunk
    assert not pygradflow_torch.Solver(tprob.Rosenbrock(), P(), device="cpu")._loop.decide_route()


def test_host_evaluating_problems_route_eagerly(fake_pycutest):  # noqa: F811
    """CUTEst's problems and ``--debug_nans``'s checked problems declare
    ``evaluates_on_host``; the route sends them to the eager loop from the
    problem alone, and a pure tensor problem to the graph."""
    from pygradflow_torch.runners.cutest_runner import CUTEstRunner
    from pygradflow_torch.runners.instance import FiniteCheckProblem

    P = pygradflow_torch.Params
    runner = CUTEstRunner()
    problems = [inst.problem() for inst in runner.get_instances(runner.parser().parse_args([]))]
    assert {type(p).__name__ for p in problems} == {"CUTEstProblem", "CUTEstNEProblem"}
    problems.append(FiniteCheckProblem(tprob.HS71()))
    for problem in problems:
        assert "evaluates on the host" in graph_route(P(), problem=problem)
        solver = pygradflow_torch.Solver(problem, P(), device="cpu")
        assert "evaluates on the host" in graph_route(solver.params, solver.callbacks, solver.transform.orig_problem)
    assert graph_route(P(), problem=tprob.HS71()) is None


def test_device_launch_counts_reach_the_host_counters():
    """Launches counted on a device (by CUDA graph replays) are added to the
    host counters once per read, as the difference since the last read.  A
    wrapper module registered after a device's counts were made (imported
    after a first graphed solve) has its entry there too."""
    from pygradflow_torch.linalg import ldlt_kernels as lk
    from pygradflow_torch.util import (
        _DEVICE_LAUNCHES,
        LAUNCH_COUNTERS,
        LAUNCH_SLOTS,
        add_device_launches,
        device_launches,
        register_launches,
    )

    device = torch.device("cpu")  # the bookkeeping alone; a CPU launch counts on the host
    before = dict(lk.LAUNCHES)
    late = {"late": 0}
    try:
        counts = device_launches(device)
        assert counts.numel() == LAUNCH_SLOTS
        register_launches(late)
        keys = [(c, k) for c in LAUNCH_COUNTERS for k in c]
        rl = next(i for i, (c, k) in enumerate(keys) if c is lk.LAUNCHES and k == "rl")
        counts[rl] += 3
        counts[len(keys) - 1] += 1
        add_device_launches(device, counts.tolist())
        assert lk.LAUNCHES["rl"] == before["rl"] + 3 and late["late"] == 1
        counts[rl] += 2
        add_device_launches(device, counts.tolist())
        add_device_launches(device, counts.tolist())
        assert lk.LAUNCHES == {**before, "rl": before["rl"] + 5} and late["late"] == 1
        with pytest.raises(RuntimeError, match="LAUNCH_SLOTS"):
            register_launches({str(i): 0 for i in range(LAUNCH_SLOTS)})
    finally:
        _DEVICE_LAUNCHES.pop(device, None)
        del LAUNCH_COUNTERS[[c is late for c in LAUNCH_COUNTERS].index(True)]
        lk.LAUNCHES.update(before)


def _fake_chunk(k, first_done, lookahead):
    """``replay_until_done`` over a fake card: replay ``i`` (from 0) writes
    its done flag, true from the ``first_done``-th replay (from 1) on, into
    slot ``i % (lookahead + 1)`` of a ring, as ``ChunkGraph.run`` does.  A
    read must find its replay's own flag still in its slot and must be the
    flag of replay ``i - lookahead``, where ``i`` is the replay about to be
    enqueued.  Returns the count returned, the replays made and the reads
    (replay index, flag read)."""
    slots = lookahead + 1
    writer, made, reads = {}, [], []

    def replay(i):
        assert i == len(made)
        made.append(i)
        writer[i % slots] = i

    def done(i):
        assert writer[i % slots] == i, "the slot was overwritten by a later replay"
        assert i == len(made) - lookahead
        reads.append((i, i + 1 >= first_done))
        return reads[-1][1]

    return replay_until_done(replay, done, k, lookahead), made, reads


@pytest.mark.parametrize("lookahead", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 7, 64])
def test_replays_stop_at_the_exact_count(k, lookahead):
    """If replay ``t`` is the first whose state is terminal, a chunk makes
    exactly ``min(k, t + lookahead - 1)`` replays, for every ``t``."""
    for t in range(1, k + 2):
        n, made, _ = _fake_chunk(k, t, lookahead)
        assert n == len(made) == min(k, t + lookahead - 1), t
        assert made == list(range(n))


@pytest.mark.parametrize("lookahead", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 7, 64])
def test_replays_run_k_when_nothing_ends(k, lookahead):
    """A chunk in which no replay's state is terminal runs all ``k``
    replays, reading a flag before each one past the first ``lookahead``."""
    n, made, reads = _fake_chunk(k, 10**9, lookahead)
    assert n == k and made == list(range(k))
    assert [i for i, _ in reads] == list(range(max(0, k - lookahead)))
    assert not any(flag for _, flag in reads)


@pytest.mark.parametrize("lookahead", [1, 2, 3])
def test_replays_never_stop_before_a_terminal_flag(lookahead):
    """A chunk stops only on a flag that read true, after the replay that
    made the state terminal: every replay up to the first terminal one is
    made, and only the last read may be true."""
    k = 20
    for t in range(1, k + 2):
        n, made, reads = _fake_chunk(k, t, lookahead)
        assert n >= min(k, t)
        assert not any(flag for _, flag in reads[:-1])
        if n < k:
            assert reads[-1] == (n - lookahead, True) and n - lookahead + 1 >= t


def test_replays_read_the_flag_of_replay_i_minus_lookahead():
    """With the module's ``LOOKAHEAD``, each read before replay ``i`` is of
    replay ``i - LOOKAHEAD``'s own slot (``_fake_chunk`` asserts it at every
    read), and ``LOOKAHEAD - 1`` replays are made past the first terminal
    one."""
    assert LOOKAHEAD >= 2  # at least one body stays queued while the host reads
    n, made, reads = _fake_chunk(64, 31, LOOKAHEAD)
    assert n == 31 + LOOKAHEAD - 1
    assert [i for i, _ in reads] == list(range(n - LOOKAHEAD + 1))
