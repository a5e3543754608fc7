"""The ``cops-chain`` configuration as ``pygradflow_torch`` runs it: the
hanging chain of COPS 3.0 in its trapezoidal optimal-control form, each
instance's end heights and length (a, b, L) moved by a delta of its own,
so that every answer belongs to one instance.  Written here, not imported
from the port or its tests, so that later edits there do not move the
benchmark."""

import numpy as np
import torch

from pygradflow_torch.parallel.batch import ParametricProblem

# the names of the problem's data leaves, in the order of its data tuple;
# the traffic draws each (``traffic/<mix>.json``'s ``data``)
DATA = ("delta",)


class HangingChain(ParametricProblem):
    """``min x2(1)`` over [u, x1, x2, x3] (each ``nh + 1`` grid values)
    subject to the trapezoidal defects of x1' = u, x2' = x1 sqrt(1 + u^2),
    x3' = sqrt(1 + u^2) on ``nh`` intervals of [0, 1], and x1(0) = a,
    x1(1) = b, x2(0) = 0, x3(0) = 0, x3(1) = L for the instance's
    (a, b, L) = published + delta.  A single ``Solver`` evaluates with
    ``example_data``, whose tensor the caller overwrites in place to pose
    the next instance."""

    def __init__(self, a, b, L, nh, device, dtype):
        self.a, self.b, self.L = a, b, L
        self.nh = nh
        self.k = nh + 1
        delta = torch.zeros(3, dtype=dtype, device=device)
        free = np.full(4 * self.k, np.inf)
        super().__init__(-free, free, example_data=(delta,), num_cons=3 * nh + 5)

    def p_obj(self, v, data):
        return v[3 * self.k - 1]

    def p_cons(self, v, data):
        (delta,) = data
        k, half = self.k, 0.5 / self.nh
        u, x1, x2, x3 = v[:k], v[k : 2 * k], v[2 * k : 3 * k], v[3 * k :]
        arc = torch.sqrt(1.0 + u * u)
        energy = x1 * arc
        d1 = x1[1:] - x1[:-1] - half * (u[1:] + u[:-1])
        d2 = x2[1:] - x2[:-1] - half * (energy[1:] + energy[:-1])
        d3 = x3[1:] - x3[:-1] - half * (arc[1:] + arc[:-1])
        ends = torch.stack([x1[0] - (self.a + delta[0]), x1[-1] - (self.b + delta[1]), x2[0], x3[0],
                            x3[-1] - (self.L + delta[2])])
        return torch.cat([d1, d2, d3, ends])


def make_problem(numbers, size, device, dtype):
    return HangingChain(nh=size["nh"], device=device, dtype=dtype, **numbers["problem"])


def base_start(problem):
    """COPS's guess from the published (a, b, L): x1 the parabola
    4 |b - a| t (t/2 - tmin) + a with tmin = 0.25 (b > a), u its slope,
    x2 and x3 the trapezoidal integrals of x1 sqrt(1 + u^2) and
    sqrt(1 + u^2)."""
    a, b = problem.a, problem.b
    tmin = 0.25 if b > a else 0.75
    t = np.linspace(0.0, 1.0, problem.k)
    x1 = 4 * abs(b - a) * t * (0.5 * t - tmin) + a
    u = 4 * abs(b - a) * (t - tmin)
    arc = np.sqrt(1.0 + u * u)
    half = 0.5 / problem.nh
    x2 = np.concatenate([[0.0], np.cumsum(half * (x1[1:] * arc[1:] + x1[:-1] * arc[:-1]))])
    x3 = np.concatenate([[0.0], np.cumsum(half * (arc[1:] + arc[:-1]))])
    return np.concatenate([u, x1, x2, x3])
