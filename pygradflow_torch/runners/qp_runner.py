"""QP benchmark runner (counterpart of ``pygradflow_tpu/runners/qp_runner.py``):
box-constrained discretized-Laplacian QPs of increasing size and random
strictly convex QPs with equality constraints, on the port's
``QuadraticProblem``.

Run: ``python -m pygradflow_torch.runners.qp_runner --no_output``
"""

import numpy as np

from ..problem import QuadraticProblem
from .instance import Instance
from .runner import Runner


def laplacian_qp(n: int) -> QuadraticProblem:
    h = 1.0 / (n + 1)
    main = 2.0 * np.ones(n)
    off = -1.0 * np.ones(n - 1)
    Q = (np.diag(main) + np.diag(off, 1) + np.diag(off, -1)) / h**2
    t = np.linspace(h, 1.0 - h, n)
    c = -(np.pi**2) * np.sin(np.pi * t)
    return QuadraticProblem(Q, c, var_lb=np.zeros(n), var_ub=np.full(n, np.inf))


def random_eq_qp(n: int, m: int, seed: int = 0) -> QuadraticProblem:
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, n))
    Q = L @ L.T + n * np.eye(n)
    c = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    return QuadraticProblem(Q, c, A=A, cons_lb=b, cons_ub=b)


class QPInstance(Instance):
    def __init__(self, name, factory, num_vars, num_cons):
        super().__init__(name, num_vars, num_cons)
        self.factory = factory

    def problem(self):
        return self.factory()

    def x0(self):
        return 0.0


class QPRunner(Runner):
    def __init__(self):
        super().__init__(name="qp")

    def get_instances(self, args):
        instances = []
        for n in [49, 199]:
            instances.append(
                QPInstance(f"laplacian{n}", lambda n=n: laplacian_qp(n), n, 0)
            )
        for n, m in [(32, 8), (64, 16)]:
            instances.append(
                QPInstance(
                    f"randeq{n}x{m}",
                    lambda n=n, m=m: random_eq_qp(n, m),
                    n,
                    m,
                )
            )
        return instances


if __name__ == "__main__":
    QPRunner().main()
