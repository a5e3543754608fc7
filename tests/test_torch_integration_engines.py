"""The port's device and flat engines against its host engine and the JAX
package's counts, and the masked loops' independence of the host-read
cadence and of the graph pair's fast/full split, on the CPU."""

import numpy as np
import pytest
import torch

from pygradflow_torch import IntegrationMethod, Params, SolverStatus
from pygradflow_torch.integration import IntegrationSolver, integrator
from pygradflow_torch.integration.batch import BatchedIntegrationSolver
from pygradflow_torch.util import HOST_READS

from .torch_parity import HS71Explicit, SingleActiveSetProblem, TameExplicit, numpy, tensor

BASE = dict(iteration_limit=1000, rho=1e-2)
STARTS = {
    "hs71": (HS71Explicit, [1.0, 5.0, 5.0, 1.0, 0.0], [0.0, 0.0]),
    "tame": (TameExplicit, [0.0, 0.0], [0.0]),
    "single_active": (SingleActiveSetProblem, [1.5, 10.0], []),
}
# (segments, steps, Newton steps, final rho) of the port's host engine.
# tests/test_torch_integration_solver.py holds them against live runs of
# the JAX package's host engine: from the same start, and for HS71 under
# SDIRK4 from x0[2] = 5 + 2^-50 (JAX's nominal start gives 10/195/2432)
HOST_COUNTS = {
    ("hs71", "TRBDF2"): (10, 357, 1785, 1e6),
    ("hs71", "SDIRK4"): (9, 189, 2400, 1e5),
    ("tame", "TRBDF2"): (12, 684, 2697, 1e9),
    ("tame", "SDIRK4"): (11, 240, 2318, 1e8),
}
ENGINES = {"host": {}, "device": dict(integration_device_loop=True)}
ENGINES["flat"] = dict(ENGINES["device"], time_limit=9000.0)


def _solve(name, **kwargs):
    cls, x0, y0 = STARTS[name]
    return IntegrationSolver(cls(), Params(**BASE, **kwargs), device="cpu").solve(tensor(x0), tensor(y0))


def _counts(res):
    return (res.iterations, res.num_integration_steps, res.num_newton_steps, res.final_rho)


@pytest.mark.parametrize("method", ["TRBDF2", "SDIRK4"])
@pytest.mark.parametrize("name", ["hs71", "tame"])
def test_engines_equal_host_and_jax(name, method):
    """The three engines take the same steps: equal counts and bitwise x;
    the flat engine's path length adds the distance after the event's box
    clip, so its dist_factor may differ in the last digits."""
    runs = {engine: _solve(name, integration_method=IntegrationMethod[method], **kw) for engine, kw in ENGINES.items()}
    host = runs["host"]
    assert host.status == SolverStatus.Optimal
    assert _counts(host) == HOST_COUNTS[name, method]
    for engine in ("device", "flat"):
        res = runs[engine]
        assert res.status == host.status and _counts(res) == _counts(host), engine
        assert torch.equal(res.x, host.x) and torch.equal(res.y, host.y), engine
    assert runs["device"].dist_factor == host.dist_factor
    assert abs(runs["flat"].dist_factor - host.dist_factor) <= 1e-8
    assert runs["flat"].num_work_units >= host.num_integration_steps


@pytest.mark.slow
def test_hs71_implicit_euler_flat():
    """HS71 under implicit Euler on the flat engine (its probes take the
    step-doubled step) is a knife edge in the JAX package itself: its run
    from the nominal start gives 10 / 4,027 / 37,214, from x0[2] one ulp
    below 5 10 / 3,936 / 35,375.  The port's 10 / 4,009 / 36,980 parts
    from JAX's nominal run by less than that: the same status, segments and
    final rho, x within 1e-6 (ROADMAP Queue C)."""
    import pygradflow_tpu
    import pygradflow_tpu.integration
    from tests import problems

    def jax_run(x0):
        params = pygradflow_tpu.Params(
            **BASE, **ENGINES["flat"], integration_method=pygradflow_tpu.IntegrationMethod.ImplicitEuler
        )
        return pygradflow_tpu.integration.IntegrationSolver(problems.HS71(), params).solve(x0, np.zeros(2))

    x0 = np.array(STARTS["hs71"][1])
    nominal = jax_run(x0)
    nudged = jax_run(np.where(np.arange(5) == 2, np.nextafter(5.0, 0.0), x0))
    assert (nominal.status.name, *_counts(nominal)) == ("Optimal", 10, 4027, 37214, 1e6)
    assert (nudged.status.name, *_counts(nudged)) == ("Optimal", 10, 3936, 35375, 1e6)
    res = _solve("hs71", integration_method=IntegrationMethod.ImplicitEuler, **ENGINES["flat"])
    assert (res.status.name, *_counts(res)) == ("Optimal", 10, 4009, 36980, 1e6)
    parted = abs(res.num_integration_steps - nominal.num_integration_steps)
    assert parted < abs(nudged.num_integration_steps - nominal.num_integration_steps)
    np.testing.assert_allclose(numpy(res.x), np.asarray(nominal.x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,x0", [("SimpleUnboundedProblem", [0.0]), ("ActiveSetChangeProblem", [10.0])])
def test_flat_implicit_euler_matches_jax(name, x0):
    """The flat engine's implicit-Euler deviation (step-doubled probes,
    growth cap 10): JAX's counts, not the host engine's (21 and 1,280
    steps there), on the small problems."""
    import pygradflow_tpu
    import pygradflow_tpu.integration
    import tests.test_integration_solver as jax_problems
    import tests.torch_parity as twins

    kwargs = dict(BASE, integration_device_loop=True, time_limit=9000.0)
    jp = pygradflow_tpu.Params(**kwargs, integration_method=pygradflow_tpu.IntegrationMethod.ImplicitEuler)
    ref = pygradflow_tpu.integration.IntegrationSolver(getattr(jax_problems, name)(), jp).solve(
        np.array(x0), np.array([])
    )
    params = Params(**kwargs, integration_method=IntegrationMethod.ImplicitEuler)
    res = IntegrationSolver(getattr(twins, name)(), params, device="cpu").solve(tensor(x0), tensor([]))
    assert (res.status.name, *_counts(res)) == (ref.status.name, *_counts(ref))
    np.testing.assert_allclose(numpy(res.x), np.asarray(ref.x), rtol=0, atol=1e-8)


def test_flat_time_limit():
    res = _solve("hs71", integration_device_loop=True, time_limit=1e-9, integration_chunk=8)
    assert res.status == SolverStatus.TimeLimit
    assert res.num_work_units == 8


@pytest.mark.parametrize("engine", ["host", "flat"])
def test_read_cadence_does_not_change_the_result(engine, monkeypatch):
    """Masked loops read on the host every k iterations; k = 1 and k = 16
    give the same bits and counts (k = 16 reads less), on a problem whose
    solve crosses an event (2 segments, 129 steps)."""
    runs = {}
    for every in (1, 16):
        monkeypatch.setattr(integrator, "READ_EVERY", every)
        HOST_READS.clear()
        runs[every] = (_solve("single_active", integration_method=IntegrationMethod.SDIRK4, **ENGINES[engine]),
                       sum(HOST_READS.values()))
    (one, reads_one), (sixteen, reads_sixteen) = runs[1], runs[16]
    assert _counts(one) == _counts(sixteen) == (2, 129, 1282, 1e-2)
    assert torch.equal(one.x, sixteen.x) and torch.equal(one.y, sixteen.y)
    assert one.dist_factor == sixteen.dist_factor
    assert reads_sixteen < reads_one


def _lane_state(B=4, units=24):
    """Perturbed HS71 lanes under SDIRK4 advanced ``units`` work units."""
    rng = np.random.default_rng(7)
    x0s = np.clip(np.array([1.0, 5.0, 5.0, 1.0, 0.0]) + rng.uniform(-0.1, 0.1, (B, 5)), 1.0, 5.0)
    x0s[:, 4] = 0.0
    solver = BatchedIntegrationSolver(
        HS71Explicit(), Params(**BASE, integration_method=IntegrationMethod.SDIRK4, integration_chunk=units),
        device="cpu",
    )
    runner = solver.runner
    x, y = torch.func.vmap(solver.inner.transform.transform_sol)(tensor(x0s), torch.zeros((B, 2), dtype=torch.float64))
    return runner, runner.chunk(runner.init(x, y))


def test_graph_pair_fast_equals_full_where_unflagged():
    """The flat unit that a card replays as a graph pair, run eagerly with
    no host read: the fast variant (Newton capped at FAST_NEWTON_TRIPS, no
    escalation) equals the full one bit for bit on every lane it does not
    flag, and the full one equals the eager unit with host reads.  Steps of
    up to 3 on three of the lanes make the frozen Newton fail there."""
    runner, state = _lane_state()
    state["h"] = torch.tensor([1e-4, 0.3, 1.0, 3.0], dtype=torch.float64)
    keys = tuple(state)
    runner._keys = keys
    flagged = 0
    for _ in range(4):
        args = tuple(state[k] for k in keys)
        fast = runner._pair.fast(*args)
        full = runner._pair.full(*args)
        eager = runner._chunk(dict(state), 1)
        need = fast[-1]
        assert not full[-1].any()
        for k, a, b in zip(keys, fast[:-1], full[:-1]):
            keep = ~need if a.ndim == 1 else ~need[:, None]
            assert torch.equal(torch.where(keep, a, 0), torch.where(keep, b, 0)), k
            assert torch.equal(b, eager[k]), k
        flagged += int(need.sum())
        state = dict(zip(keys, full[:-1]))
    assert flagged >= 1
