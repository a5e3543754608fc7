"""The port's ``IntegrationSolver`` (host engine) against the JAX package's,
on the CPU.

The counts of a continuous solve (segments, integration steps, Newton
steps) hang on event decisions that a last-bit difference can flip:
from the same start the two packages take the same steps where they agree
to the ulp along the whole trajectory.  HS71 under SDIRK4 is a knife edge:
the JAX package's own run from a start one ulp away takes the trajectory
the port takes from the nominal start, and the port takes JAX's nominal
trajectory from a start 9e-15 away; both are held here (ROADMAP Queue C).
"""

import functools

import numpy as np
import pytest

import pygradflow_tpu
import pygradflow_tpu.integration
from pygradflow_torch import DerivCheck, IntegrationMethod, Params, Precision
from pygradflow_torch.integration import IntegrationSolver, ShardedIntegrationSolver
from tests import problems
from tests.test_integration_solver import SimpleProblem as JaxSimpleProblem

from .torch_parity import (
    ActiveSetChangeProblem,
    HS71Explicit,
    SimpleProblem,
    SimpleUnboundedProblem,
    SingleActiveSetProblem,
    TameExplicit,
    numpy,
    tensor,
)

X_TOL = 1e-8
BASE = dict(iteration_limit=1000, rho=1e-2)
HS71_X0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])
HS71_Y0 = np.zeros(2)
TAME_X0, TAME_Y0 = np.zeros(2), np.zeros(1)
PROBLEMS = {
    "hs71": (problems.HS71, HS71Explicit, HS71_X0, HS71_Y0),
    "tame": (problems.Tame, TameExplicit, TAME_X0, TAME_Y0),
}


def _params(package, **kwargs):
    kwargs = {**BASE, **kwargs}
    if "integration_method" in kwargs:
        kwargs["integration_method"] = package.IntegrationMethod[kwargs["integration_method"]]
    return package.Params(**kwargs)


@functools.lru_cache(maxsize=None)
def _jax_run(name, x0=None, **kwargs):
    jax_cls, _, x_start, y_start = PROBLEMS[name]
    x0 = x_start if x0 is None else np.array(x0)
    return pygradflow_tpu.integration.IntegrationSolver(jax_cls(), _params(pygradflow_tpu, **kwargs)).solve(
        x0, y_start
    )


@functools.lru_cache(maxsize=None)
def _port_run(name, x0=None, **kwargs):
    _, torch_cls, x_start, y_start = PROBLEMS[name]
    x0 = x_start if x0 is None else np.array(x0)
    import pygradflow_torch

    return IntegrationSolver(torch_cls(), _params(pygradflow_torch, **kwargs), device="cpu").solve(
        tensor(x0), tensor(y_start)
    )


def _counts(res):
    return (res.status.name, res.iterations, res.num_integration_steps, res.num_newton_steps, res.final_rho)


def assert_same_continuous(ours, ref, tol=X_TOL):
    """Status, segments, steps, Newton steps and final rho equal; x, y and
    dist_factor within ``tol``."""
    assert _counts(ours) == _counts(ref)
    np.testing.assert_allclose(numpy(ours.x), np.asarray(ref.x), rtol=0, atol=tol)
    np.testing.assert_allclose(numpy(ours.y), np.asarray(ref.y), rtol=0, atol=tol)
    assert abs(ours.dist_factor - ref.dist_factor) <= tol


# the JAX package's counts on the CPU (status, segments, steps, Newton
# steps, final rho)
JAX_ANCHORS = {
    ("hs71", "TRBDF2"): ("Optimal", 10, 357, 1785, 1e6),
    ("tame", "TRBDF2"): ("Optimal", 12, 684, 2697, 1e9),
    ("tame", "SDIRK4"): ("Optimal", 11, 240, 2318, 1e8),
    ("hs71", "SDIRK4"): ("Optimal", 10, 195, 2432, 1e6),
}


@pytest.mark.parametrize("name,method", [("hs71", "TRBDF2"), ("tame", "TRBDF2"), ("tame", "SDIRK4")])
def test_host_engine_matches_jax(name, method):
    ref = _jax_run(name, integration_method=method)
    assert _counts(ref) == JAX_ANCHORS[name, method]
    assert_same_continuous(_port_run(name, integration_method=method), ref)


def test_hs71_sdirk4_knife_edge():
    """From the nominal start the port takes the trajectory that the JAX
    package takes from a start one ulp away (x0[2] = 5 + 2^-50), and from
    x0[2] = 5 - 9e-15 the port takes JAX's nominal one."""
    nudged_up = tuple(np.where(np.arange(5) == 2, np.nextafter(5.0, 6.0), HS71_X0))
    nudged_down = tuple(np.where(np.arange(5) == 2, 5.0 - 1e-14, HS71_X0))
    jax_nominal = _jax_run("hs71", integration_method="SDIRK4")
    assert _counts(jax_nominal) == JAX_ANCHORS["hs71", "SDIRK4"]
    jax_up = _jax_run("hs71", nudged_up, integration_method="SDIRK4")
    assert _counts(jax_up) == ("Optimal", 9, 189, 2400, 1e5)
    assert_same_continuous(_port_run("hs71", integration_method="SDIRK4"), jax_up)
    port_down = _port_run("hs71", nudged_down, integration_method="SDIRK4")
    assert _counts(port_down) == _counts(jax_nominal)
    np.testing.assert_allclose(numpy(port_down.x), np.asarray(jax_nominal.x), rtol=0, atol=X_TOL)


# the small problems of tests/test_integration_solver.py from the starts
# those tests use: (status, segments, steps, Newton steps), the JAX
# package's counts
SMALL = {
    ("SimpleProblem", "TRBDF2"): ("Optimal", 1, 442, 1768),
    ("SimpleProblem", "SDIRK4"): ("Optimal", 1, 136, 1357),
    ("SimpleUnboundedProblem", "TRBDF2"): ("Unbounded", 2, 16, 32),
    ("SimpleUnboundedProblem", "SDIRK4"): ("Unbounded", 2, 16, 80),
    ("SimpleUnboundedProblem", "ImplicitEuler"): ("Unbounded", 1, 21, 63),
    ("ActiveSetChangeProblem", "TRBDF2"): ("Optimal", 1, 91, 364),
    ("ActiveSetChangeProblem", "SDIRK4"): ("Optimal", 1, 28, 277),
    ("ActiveSetChangeProblem", "ImplicitEuler"): ("Optimal", 1, 1280, 7680),
    ("SingleActiveSetProblem", "TRBDF2"): ("Optimal", 2, 400, 1599),
    ("SingleActiveSetProblem", "SDIRK4"): ("Optimal", 2, 129, 1282),
}
SMALL_STARTS = {
    "SimpleProblem": (SimpleProblem, [10.0], [1e-6]),
    "SimpleUnboundedProblem": (SimpleUnboundedProblem, [0.0], None),
    "ActiveSetChangeProblem": (ActiveSetChangeProblem, [10.0], [1.0]),
    "SingleActiveSetProblem": (SingleActiveSetProblem, [1.5, 10.0], [1.0, 1e-6]),
}


@pytest.mark.parametrize("name,method", list(SMALL))
def test_small_problem_counts(name, method):
    cls, x0, x_opt = SMALL_STARTS[name]
    res = IntegrationSolver(cls(), Params(**BASE, integration_method=IntegrationMethod[method]), device="cpu").solve(
        tensor(x0), tensor([])
    )
    assert (res.status.name, res.iterations, res.num_integration_steps, res.num_newton_steps) == SMALL[name, method]
    if x_opt is not None:
        np.testing.assert_allclose(numpy(res.x), x_opt, atol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize(
    "name,counts",
    [("SimpleProblem", ("Optimal", 1, 5848, 35088)), ("SingleActiveSetProblem", ("Optimal", 2, 4955, 29730))],
)
def test_small_problem_implicit_euler_long(name, counts):
    cls, x0, _ = SMALL_STARTS[name]
    params = Params(**BASE, integration_method=IntegrationMethod.ImplicitEuler)
    res = IntegrationSolver(cls(), params, device="cpu").solve(tensor(x0), tensor([]))
    assert (res.status.name, res.iterations, res.num_integration_steps, res.num_newton_steps) == counts


def test_collect_path_matches_jax():
    jp = pygradflow_tpu.Params(**BASE, collect_path=True)
    ref = pygradflow_tpu.integration.IntegrationSolver(JaxSimpleProblem(), jp).solve(np.array([10.0]), np.array([]))
    ours = IntegrationSolver(SimpleProblem(), Params(**BASE, collect_path=True), device="cpu").solve(
        tensor([10.0]), tensor([])
    )
    assert ours.path.shape == tuple(np.asarray(ref.path).shape) == (1, ours.iterations + 1)
    np.testing.assert_allclose(numpy(ours.path), np.asarray(ref.path), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(numpy(ours.model_times), np.asarray(ref.model_times), rtol=0, atol=X_TOL)
    np.testing.assert_allclose(numpy(ours.path[:, -1]), numpy(ours.x), atol=1e-10)


def test_bisection_divergence_start_matches_jax():
    """Lane 9 of ``default_rng(7)``'s perturbed HS71 starts, where a
    bisection that never re-finds its crossing must fall back to the
    segment's endpoint (``tests/test_integration_solver.py:175-197``)."""
    inst = problems.hs71_instance()
    rng = np.random.default_rng(7)
    lo = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
    hi = np.array([5.0, 5.0, 5.0, 5.0, 2.0])
    x0 = tuple(np.clip(inst.x_0[None, :] + rng.uniform(-0.1, 0.1, (16, 5)), lo, hi)[9])
    ref = _jax_run("hs71", x0, integration_max_steps=20_000)
    ours = _port_run("hs71", x0, integration_max_steps=20_000)
    assert_same_continuous(ours, ref)
    np.testing.assert_allclose(numpy(ours.x), inst.x_opt, atol=1e-5)


def test_iteration_limit_matches_jax():
    ref = _jax_run("hs71", iteration_limit=2)
    ours = _port_run("hs71", iteration_limit=2)
    assert _counts(ours) == _counts(ref) == ("IterationLimit", 2, 127, 640, 1.0)
    np.testing.assert_allclose(numpy(ours.x), np.asarray(ref.x), rtol=0, atol=1e-9)


@pytest.mark.parametrize(
    "kwargs,item",
    [
        (dict(precision=Precision.Single, opt_tol=1e-4, lamb_min=1e-6), "A7"),
        (dict(display=True), "A12"),
        (dict(deriv_check=DerivCheck.CheckFirst), "A12"),
    ],
)
def test_unported_options_raise(kwargs, item):
    """The options that raised naming ROADMAP A7 and A12 until they were
    ported: each now builds on HS71 and solves Tame to Optimal."""
    IntegrationSolver(HS71Explicit(), Params(**kwargs), device="cpu")
    res = IntegrationSolver(TameExplicit(), Params(**BASE, **kwargs), device="cpu").solve(
        tensor([0.0, 0.0]), tensor([0.0])
    )
    assert res.status.name == "Optimal"
    assert res.x.dtype == Params(**kwargs).dtype


def test_sharded_solver_names_its_item():
    with pytest.raises(NotImplementedError, match="A12"):
        ShardedIntegrationSolver(HS71Explicit(), Params())

