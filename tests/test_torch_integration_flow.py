"""The continuous engine's building blocks against the JAX package's: the
flow (``integration/flow.py``), its events (``events.py``), both filters,
and one step of each integrator (``integrator.py``), at seeded points.

Both packages evaluate in f64 with the same operations but sum in their
own orders, so values agree to 1e-12, and the Newton decisions (``ok``,
iteration counts) are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_tpu
from pygradflow_torch import Params
from pygradflow_torch.integration import device_loop, events, flow, integrator
from pygradflow_torch.integration import IntegrationSolver
from pygradflow_torch.transform import Transformation
from pygradflow_tpu.integration import device_loop as jax_device_loop
from pygradflow_tpu.integration import events as jax_events
from pygradflow_tpu.integration import flow as jax_flow
from pygradflow_tpu.integration import integrator as jax_integrator
from pygradflow_tpu.integration import IntegrationSolver as JaxIntegrationSolver
from pygradflow_tpu.transform import Transformation as JaxTransformation
from tests import problems

from .torch_parity import BoundedQuad, HS71, SimpleProblem, Tame, numpy, tensor

TOL = 1e-12

CASES = {
    "hs71": (problems.HS71, HS71, np.array([1.0, 1.0, 1.0, 1.0, 0.0]), np.array([5.0, 5.0, 5.0, 5.0, 2.0]), 2),
    "tame": (problems.Tame, Tame, np.array([-1.0, -1.0]), np.array([1.0, 1.0]), 1),
    "bounded": (
        lambda: problems.BoundedQuad(np.array([0.3, 1.7, -0.4])),
        lambda: BoundedQuad(np.array([0.3, 1.7, -0.4])),
        np.zeros(3),
        np.ones(3),
        0,
    ),
}


def _contexts(name):
    jax_cls, torch_cls, lo, hi, m = CASES[name]
    jp = pygradflow_tpu.Params()
    jt = JaxTransformation(jax_cls(), jp)
    tt = Transformation(torch_cls(), Params(), "cpu")
    jprob, tprob = jt.trans_problem, tt.trans_problem
    jctx = jax_flow.FlowCtx(fns=jt.fns, lb=jnp.asarray(jprob.var_lb), ub=jnp.asarray(jprob.var_ub))
    tctx = flow.FlowCtx(fns=tt.fns, lb=tensor(tprob.var_lb), ub=tensor(tprob.var_ub))
    return jctx, tctx, lo, hi, m


def _points(name, count=4):
    """Seeded points inside the box (x) with duals, the first with its
    first coordinate on the lower bound; filters with one pinned variable."""
    _, _, lo, hi, m = CASES[name]
    rng = np.random.default_rng(11)
    x = lo + (hi - lo) * rng.uniform(0.05, 0.95, (count, lo.size))
    x[0, 0] = lo[0]
    y = rng.standard_normal((count, m))
    filt = np.ones((count, lo.size), dtype=bool)
    filt[1, 0] = False
    return np.concatenate([x, y], axis=1), filt


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(numpy(ours), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_flow_functions_match_jax(name):
    jctx, tctx, _, _, _ = _contexts(name)
    zs, filts = _points(name)
    for z, filt, rho in zip(zs, filts, [1e-2, 1.0, 10.0, 1e3]):
        jz, tz = jnp.asarray(z), tensor(z)
        jf, tf = jnp.asarray(filt), torch.as_tensor(filt)
        _close(flow.rhs(tctx, tz, rho, tf), jax_flow.rhs(jctx, jz, rho, jf))
        _close(flow.rhs(tctx, tz, rho), jax_flow.rhs(jctx, jz, rho))
        _close(flow.rhs_jac(tctx, tz, rho, tf), jax_flow.rhs_jac(jctx, jz, rho, jf))
        f, J = flow.rhs_and_jac(tctx, tz, rho, tf)
        _close(f, jax_flow.rhs(jctx, jz, rho, jf))
        _close(J, jax_flow.rhs_jac(jctx, jz, rho, jf))
        _close(flow.rhs_deriv_x(tctx, tz, rho), jax_flow.rhs_deriv_x(jctx, jz, rho))
        _close(flow.residuum(tctx, tz, tf), jax_flow.residuum(jctx, jz, jf))
        _close(flow.obj(tctx, tz), jax_flow.obj(jctx, jz))


@pytest.mark.parametrize("name", list(CASES))
def test_events_match_jax(name):
    jctx, tctx, _, _, _ = _contexts(name)
    jcfg = jax_events.EventCfg(ctx=jctx, opt_tol=1e-6, obj_lower_limit=-1e10, active_tol=1e-8)
    tcfg = events.EventCfg(ctx=tctx, opt_tol=1e-6, obj_lower_limit=-1e10, active_tol=1e-8)
    zs, filts = _points(name)
    n = tctx.n
    prev = None
    for z, filt in zip(zs, filts):
        jz, tz = jnp.asarray(z), tensor(z)
        jf, tf = jnp.asarray(filt), torch.as_tensor(filt)
        jdirs = jax_events.grad_event_dirs(jctx, jz, jf, jctx.lb, jctx.ub)
        tdirs = events.grad_event_dirs(tctx, tz, tf, tctx.lb, tctx.ub)
        np.testing.assert_array_equal(numpy(tdirs), np.asarray(jdirs))
        jvals = jax_events.event_values(jcfg, jz, 10.0, jf, jdirs)
        tvals = events.event_values(tcfg, tz, 10.0, tf, tdirs)
        _close(tvals, jvals)
        assert tvals.shape == (events.num_events(n),)
        jdir = jax_events.event_directions(jcfg, jf, jdirs)
        tdir = events.event_directions(tcfg, tf, tdirs)
        np.testing.assert_array_equal(numpy(tdir), np.asarray(jdir))
        if prev is not None:
            np.testing.assert_array_equal(
                numpy(events.crossings(tensor(prev), tvals, tdir)),
                np.asarray(jax_events.crossings(jnp.asarray(prev), jvals, jdir)),
            )
        prev = numpy(tvals)
    # every direction of a crossing, both signs and zero
    a = np.array([1.0, -1.0, 1.0, -1.0, 0.0, 1.0, -2.0, 0.5, 0.0])
    b = np.array([-1.0, 1.0, 0.0, 0.0, 1.0, 1.0, 3.0, -0.5, -1.0])
    for d in (-1.0, 0.0, 1.0):
        dirs = np.full(a.shape, d)
        np.testing.assert_array_equal(
            numpy(events.crossings(tensor(a), tensor(b), tensor(dirs))),
            np.asarray(jax_events.crossings(jnp.asarray(a), jnp.asarray(b), jnp.asarray(dirs))),
        )


@pytest.mark.parametrize("name", list(CASES))
def test_filters_match_jax(name):
    """The host filter and the traced one at points on a bound, with the
    gradient pointing in and out."""
    jax_cls, torch_cls, lo, hi, m = CASES[name]
    jsolver = JaxIntegrationSolver(jax_cls(), pygradflow_tpu.Params())
    tsolver = IntegrationSolver(torch_cls(), Params(), device="cpu")
    zs, _ = _points(name)
    zs[2, : lo.size] = np.where(np.arange(lo.size) % 2 == 0, lo, hi)
    for z in zs:
        for rho in (1e-2, 1e2):
            jz, tz = jnp.asarray(z), tensor(z)
            ref = np.asarray(jsolver.create_filter(jz, rho))
            np.testing.assert_array_equal(numpy(tsolver.create_filter(tz, rho)), ref)
            traced = jax_device_loop._create_filter(jsolver.ctx, jsolver.lb, jsolver.ub, jz, rho)
            ours = device_loop._create_filter(tsolver.ctx, tsolver.lb, tsolver.ub, tz, torch.tensor(rho))
            np.testing.assert_array_equal(numpy(ours), np.asarray(traced))


class _JaxFlat(pygradflow_tpu.Problem):
    """``x^2 / 2`` over ``x >= 0``: at ``x = 0`` the flow and its time
    derivative vanish on the bound."""

    def __init__(self):
        super().__init__(np.array([0.0]), np.array([np.inf]))

    def obj(self, x):
        return 0.5 * x[0] ** 2


def test_degenerate_bound_raises_like_jax():
    z = np.array([0.0])
    with pytest.raises(Exception, match="Degenerate bound"):
        JaxIntegrationSolver(_JaxFlat(), pygradflow_tpu.Params()).create_filter(jnp.asarray(z), 1.0)
    solver = IntegrationSolver(SimpleProblem(lb=0.0), Params(), device="cpu")
    with pytest.raises(Exception, match="Degenerate bound"):
        solver.create_filter(tensor(z), 1.0)
    # the traced filter leaves the variable free, as JAX's does
    free = device_loop._create_filter(solver.ctx, solver.lb, solver.ub, tensor(z), torch.tensor(1.0))
    assert numpy(free).tolist() == [True]


STEPS = {
    "trbdf2": (integrator.trbdf2_step, jax_integrator.trbdf2_step),
    "sdirk4": (integrator.sdirk4_step, jax_integrator.sdirk4_step),
}


STEP_H = [1e-3, 1e-2, 0.1, 0.3, 1.0]
"""Step sizes of the step tests: at h = 1 the frozen Newton of HS71's stages
fails and the escalation converges (a larger step parts the two packages'
Newton counts by rounding in its last, diverging iterations)."""


def _step_inputs():
    """HS71 points near the start (x clipped into the box, no slack), the
    previous accepted points beside them, and the start's filter."""
    rng = np.random.default_rng(5)
    base = np.array([1.0, 5.0, 5.0, 1.0, 0.0, 0.0, 0.0])
    zs, z_prev = [], []
    for _ in range(3):
        z = base + 0.05 * rng.standard_normal(7)
        z[:4] = np.clip(z[:4], 1.0, 5.0)
        z[4] = 0.0
        zs.append(z)
        z_prev.append(z + 1e-3 * rng.standard_normal(7))
    return zs, z_prev, np.array([False, True, True, False, False])


@pytest.mark.parametrize("hist", [False, True], ids=["no-history", "history"])
@pytest.mark.parametrize("method", list(STEPS))
def test_dirk_step_matches_jax(method, hist, monkeypatch):
    ours_fn, ref_fn = STEPS[method]
    jctx, tctx, _, _, _ = _contexts("hs71")
    zs, z_prev, filt = _step_inputs()
    ref_jit = jax.jit(
        lambda z, h, zp, hp: ref_fn(jctx, z, h, 1e-2, jnp.asarray(filt), 1e-6, 1e-9, (zp, hp) if hist else None)
    )
    # a step factors once; the escalation factors again per full Newton iteration
    factors = []
    plain_factor = integrator.plu_factor
    monkeypatch.setattr(integrator, "plu_factor", lambda a: factors.append(1) or plain_factor(a))
    escalated = 0
    for z, zp in zip(zs, z_prev):
        for h in STEP_H:
            jw, jok, jit, jest = ref_jit(jnp.asarray(z), h, jnp.asarray(zp), 0.5 * h)
            hist_t = (tensor(zp), torch.tensor(0.5 * h, dtype=torch.float64)) if hist else None
            factors.clear()
            w, ok, iters, est = ours_fn(tctx, tensor(z), h, 1e-2, torch.as_tensor(filt), 1e-6, 1e-9, hist_t)
            assert (bool(ok), int(iters)) == (bool(jok), int(jit))
            _close(w, jw)
            _close(est, jest)
            escalated += len(factors) > 1
    assert escalated >= 3  # the largest step takes the escalation


def test_implicit_euler_step_matches_jax():
    jctx, tctx, _, _, _ = _contexts("hs71")
    zs, _, filt = _step_inputs()
    ref_jit = jax.jit(lambda z, h: jax_integrator.implicit_euler_step(jctx, z, h, 1e-2, jnp.asarray(filt), 1e-6, 1e-9))
    for z in zs:
        for h in STEP_H:
            jw, jok, jit = ref_jit(jnp.asarray(z), h)
            w, ok, iters = integrator.implicit_euler_step(tctx, tensor(z), h, 1e-2, torch.as_tensor(filt), 1e-6, 1e-9)
            assert (bool(ok), int(iters)) == (bool(jok), int(jit))
            _close(w, jw)


def test_constants_equal_jax():
    names = [
        "NEWTON_MAX_IT", "NEWTON_TOL_FACTOR", "BISECT_RTOL", "BISECT_BLOWUP", "TRBDF2_GAMMA", "TRBDF2_D",
        "TRBDF2_AW", "TRBDF2_AZ", "TRBDF2_E1", "TRBDF2_E2", "TRBDF2_E3", "SDIRK4_GAMMA", "SDIRK4_A", "SDIRK4_E",
    ]
    for name in names:
        assert getattr(integrator, name) == getattr(jax_integrator, name), name
    assert device_loop.MAX_BISECT == jax_device_loop.MAX_BISECT
    assert (flow.XTOL, flow.ATOL) == (jax_flow.XTOL, jax_flow.ATOL)
    assert integrator.SDIRK4_C == (0.25, 0.75, 0.55, 0.5, 1.0)
    assert all(abs(sum(row) - c) < 1e-15 for row, c in zip(integrator.SDIRK4_A, integrator.SDIRK4_C))
