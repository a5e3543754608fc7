"""The ``rosenbrock`` configuration as ``pygradflow_torch`` runs it: the
upstream documented example's function, (1 - u)^2 + 100 (v - u^2)^2, with
each instance moved by a shift of its own, so that every answer belongs to
one instance.  Written here, not imported from the port or its tests, so
that later edits there do not move the benchmark."""

import numpy as np
import torch

from pygradflow_torch.parallel.batch import ParametricProblem

# the names of the problem's data leaves, in the order of its data tuple;
# the traffic draws each (``traffic/<mix>.json``'s ``data``)
DATA = ("shift",)


class ShiftedRosenbrock(ParametricProblem):
    """``(a - (u - s_0))^2 + b ((v - s_1) - (u - s_0)^2)^2`` over R^2 for
    the instance's shift s; optimum (a + s_0, a^2 + s_1).  A single
    ``Solver`` evaluates with ``example_data``, whose tensor the caller
    overwrites in place to pose the next instance."""

    def __init__(self, a, b, device, dtype):
        self.a = a
        self.b = b
        shift = torch.zeros(2, dtype=dtype, device=device)
        super().__init__(np.array([-np.inf, -np.inf]), np.array([np.inf, np.inf]), example_data=(shift,))

    def p_obj(self, v, data):
        (shift,) = data
        u, w = v[0] - shift[0], v[1] - shift[1]
        return (self.a - u) ** 2 + self.b * (w - u**2) ** 2


def make_problem(numbers, size, device, dtype):
    return ShiftedRosenbrock(device=device, dtype=dtype, **numbers["problem"])


def base_start(problem):
    """The documented example's start, (0, 0) (a mix that draws its starts
    uniformly ignores it)."""
    return np.array([0.0, 0.0])
