"""Helpers for the tests that hold ``pygradflow_torch`` against the JAX
package ``pygradflow_tpu``.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX side's data reaches the port only through ``pygradflow_torch.convert``.
Torch runs on one thread: the suite runs several pytest workers per core.
"""

import numpy as np
import torch

from pygradflow_torch import Problem, convert

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


def params_pair(**kwargs):
    """The same configuration for both packages."""
    import pygradflow_tpu

    jp = pygradflow_tpu.Params(**kwargs)
    return jp, convert.params_from_jax(jp)


def tensor(a):
    return convert.tensor(np.asarray(a))


def numpy(t):
    return t.detach().cpu().numpy()


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
