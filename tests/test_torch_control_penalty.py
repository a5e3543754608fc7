"""The port's step controllers, active-set types and penalty strategies
against the JAX package: the step-control, penalty and active-set sweeps of
``tests/test_solver.py`` on HS71, the unbounded QP of ``tests/test_qp.py``,
the filter ring of ``tests/test_penalty_filter.py``, the pendulum at N = 16
on the mixed-precision tier, and lockstep lanes of ``BatchedSolver``, each
against the JAX lane and the port's single ``Solver``.  Solves give equal
status, counts and evaluation counts, x, y and d within 1e-8 (1e-6 on
PallasLDLT)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch import penalty as t_penalty
from pygradflow_torch.parallel import BatchedSolver
from pygradflow_torch.problem import QuadraticProblem
from pygradflow_torch.runners.control import PendulumControl as TPendulum
from pygradflow_tpu import penalty as j_penalty
from pygradflow_tpu.parallel import BatchedSolver as JBatchedSolver
from pygradflow_tpu.runners.control import PendulumControl as JPendulum

from .test_torch_batch import _check_lanes, _check_single
from .torch_parity import ANCHOR, PALLAS_TOL, assert_same_solve, numpy, params_pair, solve_both, tensor

HS71_X0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])


def _hs71():
    from tests.problems import HS71 as JHS71

    from .torch_parity import HS71

    return JHS71(), HS71()


def _hs71_solve(**kwargs):
    jprob, tprob = _hs71()
    return solve_both(jprob, tprob, HS71_X0, np.zeros(2), **kwargs)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(step_control_type="DistanceRatio"),
        dict(step_control_type="ResiduumRatio"),
        dict(step_control_type="Exact"),
        dict(step_control_type="Fixed", iteration_limit=40),
    ],
    ids=["DistanceRatio", "ResiduumRatio", "Exact", "Fixed"],
)
def test_step_control_sweep_matches_jax(kwargs):
    """``tests/test_solver.py::test_step_control_sweep`` (``rho=1e-1``), plus
    Fixed, which keeps lambda at ``lamb_init`` and runs to its limit."""
    jr, tr = _hs71_solve(rho=1e-1, **kwargs)
    assert jr.status.name == ("IterationLimit" if "iteration_limit" in kwargs else "Optimal")
    assert_same_solve(tr, jr)


@pytest.mark.parametrize(
    "penalty_update",
    ["Constant", "DualNorm", "ParetoDecrease", "ObjectiveFilter", "LagrangianFilter"],
)
def test_penalty_sweep_matches_jax(penalty_update):
    """``tests/test_solver.py::test_penalty_sweep``."""
    jr, tr = _hs71_solve(penalty_update=penalty_update)
    assert jr.status.name == "Optimal"
    assert_same_solve(tr, jr)


def test_dual_equilibration_matches_jax():
    """``tests/test_solver.py::test_dual_equilibration_runs``: rho grows
    fast and HS71 stops at the 50-iteration limit in both packages."""
    jr, tr = _hs71_solve(penalty_update="DualEquilibration", iteration_limit=50)
    assert jr.status.name == "IterationLimit"
    assert_same_solve(tr, jr)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(active_set_type="Standard"),
        dict(active_set_type="SmallestActiveSet"),
        dict(active_set_type="Explicit", active_set_tau=0.5),
    ],
    ids=["Standard", "SmallestActiveSet", "Explicit"],
)
def test_active_set_types_match_jax(kwargs):
    """``tests/test_solver.py::test_active_set_types`` and the explicit tau."""
    jr, tr = _hs71_solve(**kwargs)
    assert jr.status.name == "Optimal"
    assert_same_solve(tr, jr)


def test_largest_active_set_matches_jax():
    """LargestActiveSet takes tau = max over variables of (x - bound) / g,
    which near the optimum divides by a gradient close to 0: at iteration
    263 of 473 the two packages' tau differ by 1e-9 relative (33643.53680637
    against 33643.53682151, from roundings of g), and the paths part.  Both
    reach Optimal; x is held to 1e-6, the JAX test's own tolerance."""
    jr, tr = _hs71_solve(active_set_type="LargestActiveSet")
    assert jr.status.name == tr.status.name == "Optimal"
    np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(numpy(tr.y), jr.y, rtol=0, atol=1e-6)


def test_active_set_method_matches_jax():
    """``params.active_set_method``: each package gets its own callable."""
    calls = {"jax": 0, "torch": 0}

    def method(key):
        def tau(iterate, lamb, rho):
            calls[key] += 1
            return 0.5

        return tau

    jprob, tprob = _hs71()
    jp = pygradflow_tpu.Params(active_set_method=method("jax"))
    tp = pygradflow_torch.Params(active_set_method=method("torch"))
    jr, tr = solve_both(jprob, tprob, HS71_X0, np.zeros(2), jparams=jp, tparams=tp)
    assert_same_solve(tr, jr)
    assert calls["torch"] == tr.iterations and calls["jax"] > 0


@pytest.mark.parametrize("active_set_type", ["SmallestActiveSet", "LargestActiveSet"])
def test_compute_tau_matches_jax(active_set_type):
    """tau at a seeded HS71 state, for one instance and per lane."""
    from pygradflow_torch import iterate as t_iter
    from pygradflow_torch.eval import lane_fns
    from pygradflow_torch.step.control import compute_tau, make_control_cfg
    from pygradflow_tpu import iterate as j_iter
    from pygradflow_tpu.step.control import compute_tau as j_compute_tau
    from pygradflow_tpu.step.control import make_control_cfg as j_make_control_cfg
    from pygradflow_tpu.transform import Transformation as JTransformation
    from pygradflow_torch.transform import Transformation

    jprob, tprob = _hs71()
    jp, tp = params_pair(active_set_type=active_set_type)
    jt, tt = JTransformation(jprob, jp), Transformation(tprob, tp)
    lb, ub = tprob.var_lb, tprob.var_ub
    jcfg = j_make_control_cfg(jt.fns, jp, jnp.asarray(lb), jnp.asarray(ub))
    tcfg = make_control_cfg(tt.fns, tp, tensor(lb), tensor(ub))
    rng = np.random.default_rng(21)
    xs = np.clip(HS71_X0 + rng.standard_normal((3, 5)), lb, ub)
    ys = rng.standard_normal((3, 2))
    taus = []
    for x, y in zip(xs, ys):
        j_it = j_iter.evaluate_iterate(jt.fns, jnp.asarray(x), jnp.asarray(y))
        t_it = t_iter.evaluate_iterate(tt.fns, tensor(x), tensor(y))
        tau = compute_tau(tcfg, t_it, 2.0, 0.3)
        np.testing.assert_allclose(float(tau), float(j_compute_tau(jcfg, j_it, 2.0, 0.3)), rtol=1e-12)
        taus.append(float(tau))
    lcfg = tcfg._replace(fns=lane_fns(tt.fns))
    lanes = t_iter.evaluate_iterate(lcfg.fns, tensor(xs), tensor(ys))
    np.testing.assert_array_equal(numpy(compute_tau(lcfg, lanes, tensor([2.0] * 3), tensor([0.3] * 3))), taus)


def _unbounded_qp(kind):
    from tests.test_qp import _unbounded_qp as j_unbounded_qp

    jprob = j_unbounded_qp()
    if kind == "jax":
        return jprob
    return QuadraticProblem(np.asarray(jprob.Q), np.asarray(jprob.c), var_lb=jprob.var_lb, var_ub=jprob.var_ub)


@pytest.mark.parametrize("step_control_type", ["Exact", "ResiduumRatio"])
def test_unbounded_qp_matches_jax(step_control_type):
    """``tests/test_qp.py::test_unbounded_qp``: the negative-curvature QP
    (n = 199) reaches Unbounded, with equal counts.  x is held to 1e-8
    relative under Exact.  Under ResiduumRatio the rejected candidate of
    iteration 25 already differs by 3% (its H + lambda I is near singular:
    lambda sweeps through the spectrum of -H), and the accepted step of
    iteration 32 by 80%; both packages still stop there, Unbounded."""
    jr, tr = solve_both(_unbounded_qp("jax"), _unbounded_qp("torch"), 0.0, step_control_type=step_control_type)
    assert jr.status.name == "Unbounded"
    assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == (jr.status.name, jr.iterations, jr.num_accepted_steps)
    assert {c.name(): int(n) for c, n in tr.num_evals.items()} == {c.name(): int(n) for c, n in jr.num_evals.items()}
    if step_control_type == "Exact":
        np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize(
    "kwargs,counts",
    [
        (dict(penalty_update="ParetoDecrease"), (30, 15)),
        (dict(penalty_update="LagrangianFilter"), (30, 15)),
        (dict(step_control_type="ResiduumRatio"), (13, 13)),
        (dict(step_control_type="Exact"), (26, 20)),
    ],
    ids=["ParetoDecrease", "LagrangianFilter", "ResiduumRatio", "Exact"],
)
def test_pendulum_controls_on_pallas_match_jax(kwargs, counts):
    """The pendulum at N = 16 on PallasLDLT (B1's plain version), as
    chip_smoke phase 8 (b) runs it at N = 128."""
    x0 = JPendulum(N=16).x0_trajectory()
    jr, tr = solve_both(JPendulum(N=16), TPendulum(N=16), x0, **dict(ANCHOR, **kwargs))
    assert jr.status.name == "Optimal" and (jr.iterations, jr.num_accepted_steps) == counts
    assert_same_solve(tr, jr, PALLAS_TOL)


FILTER_SEQUENCE = [(5.0, 5.0), (3.0, 7.0), (7.0, 3.0), (6.0, 6.0), (2.0, 2.0), (2.5, 1.0), (3.0, 3.0)]
"""Accept, accept, accept, reject (dominated by (5, 5)), accept and evict
everything, accept, reject (``tests/test_penalty_filter.py``)."""


def _ring_state(state):
    valid = np.asarray(state.valid)
    return np.asarray(state.entries)[valid].tolist(), valid.tolist(), int(state.cursor)


@pytest.mark.parametrize(
    "capacity,sequence",
    [
        (64, FILTER_SEQUENCE),
        (4, [(float(i), float(100 - i)) for i in range(12)] + [(20.0, 95.0), (0.5, 100.5)]),
    ],
    ids=["within_capacity", "past_capacity"],
)
def test_filter_insert_matches_jax(capacity, sequence):
    """``_filter_insert`` against the JAX ring, entry by entry: acceptance,
    entries, validity mask and cursor; past capacity the ring overwrites at
    its cursor in both."""
    tp = pygradflow_torch.Params(filter_capacity=capacity)
    jstate = j_penalty._filter_initial(pygradflow_tpu.Params(filter_capacity=capacity))
    tstate = t_penalty._filter_initial(tp, "cpu")
    for first, second in sequence:
        j_ok, jstate = j_penalty._filter_insert(jstate, jnp.asarray(first), jnp.asarray(second))
        t_ok, tstate = t_penalty._filter_insert(tstate, tensor(first), tensor(second))
        assert bool(t_ok) == bool(j_ok), (first, second)
        assert _ring_state(tstate) == _ring_state(jstate), (first, second)


def test_filter_insert_on_lanes_equals_single():
    """A (B, capacity, 2) ring: each lane inserts its own sequence as the
    single ring does."""
    rng = np.random.default_rng(2)
    seqs = rng.uniform(0.0, 10.0, size=(3, 20, 2))
    tp = pygradflow_torch.Params(filter_capacity=4)
    lanes = t_penalty._filter_initial(tp, "cpu", batch=3)
    singles = [t_penalty._filter_initial(tp, "cpu") for _ in range(3)]
    for k in range(20):
        ok, lanes = t_penalty._filter_insert(lanes, tensor(seqs[:, k, 0]), tensor(seqs[:, k, 1]))
        for i in range(3):
            ok_i, singles[i] = t_penalty._filter_insert(singles[i], tensor(seqs[i, k, 0]), tensor(seqs[i, k, 1]))
            assert bool(ok[i]) == bool(ok_i)
            for lane_leaf, single_leaf in zip(lanes, singles[i]):
                assert torch.equal(lane_leaf[i], single_leaf)


@pytest.mark.parametrize("penalty_update", ["ObjectiveFilter", "LagrangianFilter"])
def test_filter_solve_past_capacity_matches_jax(penalty_update):
    """``tests/test_penalty_filter.py::test_filter_solve_past_capacity_stays_sane``:
    a capacity-2 ring overwrites during the HS71 solve."""
    jr, tr = _hs71_solve(penalty_update=penalty_update, filter_capacity=2)
    assert jr.status.name == "Optimal"
    assert_same_solve(tr, jr)


def _tau_of_instance(key):
    """An ``active_set_method`` whose tau depends on the instance's own x,
    so a callable applied to the whole lane stack would give other taus."""
    if key == "jax":
        return lambda it, lamb, rho: 0.5 + 0.1 * jnp.min(jnp.abs(it.x))
    return lambda it, lamb, rho: 0.5 + 0.1 * torch.amin(torch.abs(it.x))


def _batched_both(jprob, tprob, x0s, y0s=None, **kwargs):
    """Both packages' ``BatchedSolver``; ``active_set_method=True`` gives
    each its own ``_tau_of_instance``."""
    per_instance_tau = kwargs.pop("active_set_method", False)
    jp, tp = params_pair(**kwargs)
    if per_instance_tau:
        jp = dataclasses.replace(jp, active_set_method=_tau_of_instance("jax"))
        tp = dataclasses.replace(tp, active_set_method=_tau_of_instance("torch"))
    jr = JBatchedSolver(jprob, jp).solve(x0s, y0s)
    tr = BatchedSolver(tprob, tp, device="cpu").solve(x0s, y0s)
    return jr, tr, tp


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(newton_type="Full", step_control_type="ResiduumRatio", penalty_update="LagrangianFilter"),
        dict(step_control_type="Exact", penalty_update="ParetoDecrease"),
        dict(step_control_type="Fixed", penalty_update="ObjectiveFilter", iteration_limit=15),
        dict(active_set_type="SmallestActiveSet", penalty_update="DualEquilibration", iteration_limit=15),
        dict(active_set_method=True),
        dict(newton_type="Globalized", iteration_limit=30),
    ],
    ids=[
        "Full-ResiduumRatio-LagrangianFilter",
        "Exact-ParetoDecrease",
        "Fixed-ObjectiveFilter",
        "Smallest-DualEquilibration",
        "active_set_method",
        "Globalized",
    ],
)
def test_batched_options_match_jax_and_single(kwargs):
    """Three perturbed HS71 lanes in lockstep under each option's lane
    form: Exact's inner loop and Globalized's line search run to their
    limits with no host read, a finished lane keeps its iterate and counts;
    ``active_set_method`` sees one instance at a time; each lane against the
    JAX lane and the port's single ``Solver``.  Under Full Newton,
    ResiduumRatio and the LagrangianFilter lane 0 ends on LambdaLimit after
    358 iterations in both packages, where the single ``Solver`` raises."""
    jprob, tprob = _hs71()
    x0s = np.tile(HS71_X0, (3, 1))
    x0s[1, 1], x0s[2, 2] = 4.0, 4.5
    y0s = np.zeros((3, 2))
    jr, tr, tp = _batched_both(jprob, tprob, x0s, y0s, **dict(kwargs))
    _check_lanes(tr, jr)
    for lane in range(3):
        solver = pygradflow_torch.Solver(tprob, tp, device="cpu")
        if int(tr.status[lane]) == int(pygradflow_torch.SolverStatus.LambdaLimit):
            with pytest.raises(Exception, match="exceeded maximum"):
                solver.solve(tensor(x0s[lane]), tensor(y0s[lane]))
            continue
        _check_single(tr, lane, solver.solve(tensor(x0s[lane]), tensor(y0s[lane])))


def test_pendulum_fleet_active_set_filter_matches_jax():
    """The N = 8 fleet of 4 lanes (chip_smoke phase 8 (d) at N = 64, B = 128)
    under ActiveSet Newton and the LagrangianFilter on PallasLDLT: all
    Optimal, iterations [15, 17, 17, 15], accepted [10, 11, 11, 10]."""
    rng = np.random.default_rng(0)
    x0s = JPendulum(N=8).x0_trajectory()[None, :] + 0.02 * rng.standard_normal((4, JPendulum(N=8).num_vars))
    jr, tr, tp = _batched_both(
        JPendulum(N=8), TPendulum(N=8), x0s, **dict(ANCHOR, newton_type="ActiveSet", penalty_update="LagrangianFilter")
    )
    _check_lanes(tr, jr)
    assert numpy(tr.iterations).tolist() == [15, 17, 17, 15]
    assert numpy(tr.accepted_steps).tolist() == [10, 11, 11, 10]
    for lane in (0, 1):
        single = pygradflow_torch.Solver(TPendulum(N=8), tp, device="cpu").solve(tensor(x0s[lane]))
        _check_single(tr, lane, single)
