"""Helpers for the tests that hold ``pygradflow_torch`` against the JAX
package ``pygradflow_tpu``.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX side's data reaches the port only through ``pygradflow_torch.convert``.
Torch runs on one thread: the suite runs several pytest workers per core.
"""

import numpy as np
import torch

from pygradflow_torch import Problem, convert
from pygradflow_torch.parallel import ParametricProblem

torch.set_num_threads(1)

ANCHOR = dict(linear_solver_type="PallasLDLT", iteration_limit=3000, validate_input=False)
"""The slice's configuration: the mixed-precision LDL^T tier, the rest at
the defaults."""


def saddle(rng, n, m):
    """Quasi-definite saddle matrix, as ``tests/test_pallas_ldlt.py`` makes it."""
    h = rng.standard_normal((n, n))
    k = h @ h.T + n * np.eye(n)
    j = rng.standard_normal((m, n))
    return np.block([[k, j.T], [j, -0.1 * np.eye(m)]])


def ldexp_pairs(count=20000, seed=11):
    """Seeded (x, e) pairs: x across 16 decades, both signs, with zeros,
    subnormals and infinities; |e| up to 1100, so that results overflow
    and go subnormal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(count) * 10.0 ** rng.uniform(-8, 8, count)
    x[:6] = [0.0, -0.0, 5e-324, -2.5e-310, np.inf, -np.inf]
    e = rng.integers(-1100, 1101, count)
    return x, e


def params_pair(**kwargs):
    """The same configuration for both packages."""
    import pygradflow_tpu

    jp = pygradflow_tpu.Params(**kwargs)
    return jp, convert.params_from_jax(jp)


def tensor(a):
    return convert.tensor(np.asarray(a))


def numpy(t):
    return t.detach().cpu().numpy()


F64_TOL = 1e-8
"""x, y and d of a port solve against the JAX one on the f64 tiers."""

PALLAS_TOL = 1e-6
"""The same through the mixed-precision LDL^T tier."""


def assert_same_solve(tr, jr, tol=F64_TOL):
    """A port result against a JAX one: status, iteration and accepted-step
    counts, and evaluation counts equal; x, y and d within ``tol``."""
    assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == (
        jr.status.name, jr.iterations, jr.num_accepted_steps,
    )
    assert {c.name(): int(n) for c, n in tr.num_evals.items()} == {
        c.name(): int(n) for c, n in jr.num_evals.items()
    }
    for ours, ref in ((tr.x, jr.x), (tr.y, jr.y), (tr.d, jr.d)):
        np.testing.assert_allclose(numpy(ours), np.asarray(ref), rtol=0, atol=tol)


def solve_both(jprob, tprob, x0, y0=None, jparams=None, tparams=None, **kwargs):
    """The same solve in both packages, the port on the CPU; ``kwargs``
    make the same ``Params`` for both unless ``jparams``/``tparams`` are
    given."""
    import pygradflow_torch
    import pygradflow_tpu

    jp, tp = params_pair(**kwargs)
    jp, tp = jparams or jp, tparams or tp
    jr = pygradflow_tpu.Solver(jprob, jp).solve(x0, y0)
    tr = pygradflow_torch.Solver(tprob, tp, device="cpu").solve(
        None if x0 is None else tensor(x0), None if y0 is None else tensor(y0)
    )
    return jr, tr


class Rosenbrock(Problem):
    """Torch twin of ``tests/problems.py::Rosenbrock``: unconstrained,
    optimum (a, a^2)."""

    def __init__(self, a=1.0, b=100.0):
        self.a = a
        self.b = b
        super().__init__(np.array([-np.inf, -np.inf]), np.array([np.inf, np.inf]))

    def obj(self, v):
        x, y = v[0], v[1]
        return (self.a - x) ** 2 + self.b * (y - x**2) ** 2


class BoundedQuad(Problem):
    """Torch twin of ``tests/problems.py::BoundedQuad``: ``1/2 ||x - c||^2``
    over the unit box."""

    def __init__(self, c):
        self.c = np.asarray(c, dtype=float)
        n = self.c.shape[0]
        super().__init__(np.zeros(n), np.ones(n))

    def obj(self, x):
        return 0.5 * torch.sum((x - torch.as_tensor(self.c, device=x.device)) ** 2)


class HS71(Problem):
    """Torch twin of ``tests/problems.py::HS71``: both nonlinear
    constraints as equalities through an explicit slack variable."""

    def __init__(self):
        lb = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
        ub = np.array([5.0, 5.0, 5.0, 5.0, np.inf])
        super().__init__(lb, ub, num_cons=2)

    def obj(self, x):
        xx = x[:-1]
        return xx[0] * xx[3] * (xx[0] + xx[1] + xx[2]) + xx[2]

    def cons(self, x):
        xx = x[:-1]
        s = x[-1]
        return torch.stack([torch.prod(xx) - s - 25.0, torch.dot(xx, xx) - 40.0])


TARGET_X0 = np.array([-1.0, 1.0])
TARGET_X1 = np.array([1.0, -1.0])


class TargetProblem(Problem):
    """Torch twin of ``tests/problems.py::TargetProblem``: two global optima
    with indefinite Hessian regions in between."""

    def __init__(self):
        super().__init__(np.array([-np.inf, -np.inf]), np.array([np.inf, np.inf]))

    def obj(self, x):
        d0 = x - torch.as_tensor(TARGET_X0, device=x.device)
        d1 = x - torch.as_tensor(TARGET_X1, device=x.device)
        return torch.dot(d0, d0) * torch.dot(d1, d1)


class LaplacianQP(Problem):
    """Torch twin of ``tests/problems.py::LaplacianQP``: a box-constrained QP
    with a 1-D Laplacian Hessian and hand-written derivatives."""

    def __init__(self, n=49):
        h = 1.0 / (n + 1)
        main = 2.0 * np.ones(n)
        off = -1.0 * np.ones(n - 1)
        self.A = torch.as_tensor((np.diag(main) + np.diag(off, 1) + np.diag(off, -1)) / h**2)
        t = np.linspace(h, 1.0 - h, n)
        self.b = torch.as_tensor((np.pi**2) * np.sin(np.pi * t))
        super().__init__(np.zeros(n), np.full(n, np.inf))

    def obj(self, x):
        return 0.5 * torch.dot(x, self.A @ x) - torch.dot(self.b, x)

    def obj_grad(self, x):
        return self.A @ x - self.b

    def lag_hess(self, x, y):
        return self.A


class ConstrainedRosenbrock(Problem):
    """Torch twin of ``tests/problems.py::ConstrainedRosenbrock``: box and one
    linear equality cut off the unconstrained optimum."""

    def __init__(self):
        super().__init__(np.array([-1.5, -0.5]), np.array([0.8, 2.0]), num_cons=1)

    def obj(self, v):
        return (1.0 - v[0]) ** 2 + 100.0 * (v[1] - v[0] ** 2) ** 2

    def cons(self, v):
        return (v[0] + v[1] - 1.0)[None]


class ParamRosenbrock(ParametricProblem):
    """Torch twin of ``tests/test_batch.py::ParamRosenbrock``: Rosenbrock with
    per-instance (a, b)."""

    def __init__(self):
        super().__init__(
            np.array([-np.inf, -np.inf]),
            np.array([np.inf, np.inf]),
            example_data=(torch.tensor(1.0, dtype=torch.float64), torch.tensor(100.0, dtype=torch.float64)),
        )

    def p_obj(self, v, data):
        a, b = data
        return (a - v[0]) ** 2 + b * (v[1] - v[0] ** 2) ** 2


class HS71Constrained(Problem):
    """Torch twin of ``tests/problems.py::HS71Constrained``: a ranged and an
    equality constraint with a nonzero right-hand side, so the slack
    transform has work to do."""

    def __init__(self):
        super().__init__(
            np.ones(4),
            np.full(4, 5.0),
            cons_lb=np.array([25.0, 40.0]),
            cons_ub=np.array([np.inf, 40.0]),
        )

    def obj(self, x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def cons(self, x):
        return torch.stack([torch.prod(x), torch.dot(x, x)])


class Tame(Problem):
    """Torch twin of ``tests/problems.py::Tame``: a QP on which the first
    Newton step converges, the DistanceRatio controller's early branch."""

    def __init__(self):
        super().__init__(np.full(2, -np.inf), np.full(2, np.inf), num_cons=1)

    def obj(self, z):
        return (z[0] - z[1]) ** 2

    def cons(self, z):
        return (z[0] + z[1] - 1.0)[None]


class _HSTwin(Problem):
    """A Hock-Schittkowski problem of ``pygradflow_tpu/runners/hs.py``,
    written again with torch operations (its bounds, start point and
    constraint bounds copied from the spec)."""

    x0: np.ndarray

    def __init__(self, var_lb, var_ub, cons_lb, cons_ub):
        super().__init__(var_lb, var_ub, cons_lb=cons_lb, cons_ub=cons_ub)


class HS62(_HSTwin):
    """Torch twin of ``hs62``: a blending problem with log terms and
    objective slopes near 1e4."""

    x0 = np.array([0.7, 0.2, 0.1])

    def __init__(self):
        super().__init__(np.zeros(3), np.ones(3), np.zeros(1), np.zeros(1))

    def obj(self, x):
        return -32.174 * (
            255.0 * torch.log((x[0] + x[1] + x[2] + 0.03) / (0.09 * x[0] + x[1] + x[2] + 0.03))
            + 280.0 * torch.log((x[1] + x[2] + 0.03) / (0.07 * x[1] + x[2] + 0.03))
            + 290.0 * torch.log((x[2] + 0.03) / (0.13 * x[2] + 0.03))
        )

    def cons(self, x):
        return torch.stack([x[0] + x[1] + x[2] - 1.0])


class HS104(_HSTwin):
    """Torch twin of ``hs104``: alkylation-reactor design with fractional
    powers and a ranged constraint on the objective's own expression."""

    x0 = np.array([6.0, 3.0, 0.4, 0.2, 6.0, 6.0, 1.0, 0.5])

    def __init__(self):
        super().__init__(
            np.full(8, 0.1), np.full(8, 10.0),
            np.array([0.0, 0.0, 0.0, 0.0, 1.0]), np.array([np.inf] * 4 + [4.2]),
        )

    @staticmethod
    def _f(x):
        return 0.4 * x[0] ** 0.67 * x[6] ** (-0.67) + 0.4 * x[1] ** 0.67 * x[7] ** (-0.67) + 10.0 - x[0] - x[1]

    def obj(self, x):
        return self._f(x)

    def cons(self, x):
        return torch.stack(
            [
                1.0 - 0.0588 * x[4] * x[6] - 0.1 * x[0],
                1.0 - 0.0588 * x[5] * x[7] - 0.1 * x[0] - 0.1 * x[1],
                1.0 - 4.0 * x[2] / x[4] - 2.0 / (x[2] ** 0.71 * x[4]) - 0.0588 * x[6] / x[2] ** 1.3,
                1.0 - 4.0 * x[3] / x[5] - 2.0 / (x[3] ** 0.71 * x[5]) - 0.0588 * x[7] / x[3] ** 1.3,
                self._f(x),
            ]
        )


class HS106(_HSTwin):
    """Torch twin of ``hs106``: heat-exchanger design with badly scaled
    bilinear constraints."""

    x0 = np.array([5000.0, 5000.0, 5000.0, 200.0, 350.0, 150.0, 225.0, 425.0])

    def __init__(self):
        super().__init__(
            np.array([100.0, 1000.0, 1000.0, 10.0, 10.0, 10.0, 10.0, 10.0]),
            np.array([10000.0, 10000.0, 10000.0, 1000.0, 1000.0, 1000.0, 1000.0, 1000.0]),
            np.zeros(6), np.full(6, np.inf),
        )

    def obj(self, x):
        return x[0] + x[1] + x[2]

    def cons(self, x):
        return torch.stack(
            [
                1.0 - 0.0025 * (x[3] + x[5]),
                1.0 - 0.0025 * (x[4] + x[6] - x[3]),
                1.0 - 0.01 * (x[7] - x[4]),
                x[0] * x[5] - 833.33252 * x[3] - 100.0 * x[0] + 83333.333,
                x[1] * x[6] - 1250.0 * x[4] - x[1] * x[3] + 1250.0 * x[3],
                x[2] * x[7] - 1250000.0 - x[2] * x[4] + 2500.0 * x[4],
            ]
        )


class HS71Explicit(HS71):
    """``HS71`` with its derivatives written out as elementwise expressions:
    one instance, a lane stack, the CPU and a card evaluate them in the same
    order (autodiff's reductions do not), and the continuous engine's
    thousands of evaluations skip the autodiff overhead."""

    def obj(self, x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def obj_grad(self, x):
        s = x[0] + x[1] + x[2]
        x0x3 = x[0] * x[3]
        return torch.stack([x[3] * s + x0x3, x0x3, x0x3 + 1.0, x[0] * s, torch.zeros_like(s)])

    def cons(self, x):
        return torch.stack(
            [x[0] * x[1] * x[2] * x[3] - x[4] - 25.0, x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3] - 40.0]
        )

    def cons_jac(self, x):
        a, b, c, d = x[0], x[1], x[2], x[3]
        zero = torch.zeros_like(a)
        return torch.stack(
            [
                torch.stack([b * c * d, a * c * d, a * b * d, a * b * c, zero - 1.0]),
                torch.stack([2.0 * a, 2.0 * b, 2.0 * c, 2.0 * d, zero]),
            ]
        )

    def lag_hess(self, x, y):
        a, b, c, d = x[0], x[1], x[2], x[3]
        y0, y1 = y[0], y[1]
        zero = torch.zeros_like(a)
        diag = 2.0 * y1
        h01 = d + y0 * (c * d)
        h02 = d + y0 * (b * d)
        h03 = (2.0 * a + b + c) + y0 * (b * c)
        h12 = y0 * (a * d)
        h13 = a + y0 * (a * c)
        h23 = a + y0 * (a * b)
        return torch.stack(
            [
                torch.stack([2.0 * d + diag, h01, h02, h03, zero]),
                torch.stack([h01, diag, h12, h13, zero]),
                torch.stack([h02, h12, diag, h23, zero]),
                torch.stack([h03, h13, h23, diag, zero]),
                torch.stack([zero, zero, zero, zero, zero]),
            ]
        )


class TameExplicit(Tame):
    """``Tame`` with its derivatives written out (see ``HS71Explicit``)."""

    def obj_grad(self, z):
        d = 2.0 * (z[0] - z[1])
        return torch.stack([d, -d])

    def cons_jac(self, z):
        one = torch.ones_like(z[0])
        return torch.stack([torch.stack([one, one])])

    def lag_hess(self, z, y):
        two = torch.full_like(z[0], 2.0)
        return torch.stack([torch.stack([two, -two]), torch.stack([-two, two])])


class SimpleProblem(Problem):
    """Torch twin of ``tests/test_integration_solver.py::SimpleProblem``:
    ``x^2 / 2`` on the line, derivatives written out."""

    def __init__(self, lb=-np.inf):
        super().__init__(np.array([lb]), np.array([np.inf]))

    def obj(self, x):
        return 0.5 * x[0] ** 2

    def obj_grad(self, x):
        return x

    def lag_hess(self, x, y):
        return torch.ones_like(x)[:, None]


class ActiveSetChangeProblem(SimpleProblem):
    """Torch twin of ``ActiveSetChangeProblem``: ``x^2 / 2`` over ``x >= 1``."""

    def __init__(self):
        super().__init__(lb=1.0)


class SimpleUnboundedProblem(Problem):
    """Torch twin of ``SimpleUnboundedProblem``: ``min x`` on the line."""

    def __init__(self):
        super().__init__(np.array([-np.inf]), np.array([np.inf]))

    def obj(self, x):
        return x[0]

    def obj_grad(self, x):
        return torch.ones_like(x)

    def lag_hess(self, x, y):
        return torch.zeros_like(x)[:, None]


class SingleActiveSetProblem(Problem):
    """Torch twin of ``SingleActiveSetProblem``: ``|z|^2 / 2`` over
    ``z_0 >= 1``."""

    def __init__(self):
        super().__init__(np.array([1.0, -np.inf]), np.array([np.inf, np.inf]))

    def obj(self, z):
        return 0.5 * (z[0] * z[0] + z[1] * z[1])

    def obj_grad(self, z):
        return z

    def lag_hess(self, z, y):
        one = torch.ones_like(z[0])
        zero = torch.zeros_like(z[0])
        return torch.stack([torch.stack([one, zero]), torch.stack([zero, one])])
