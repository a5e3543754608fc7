"""Plain reference of the ``rosenbrock`` configuration:
f(u, v) = (a - (u - s_0))^2 + b ((v - s_1) - (u - s_0)^2)^2 for each
answer's own shift s, unconstrained, with its gradient written out."""

import numpy as np

from reference.kkt import kkt_residuals


def residuals(x, y, data, numbers, size, active_tol):
    """``kkt.kkt_residuals`` of the answers ``x`` (L, 2); ``y`` is (L, 0);
    ``data["shift"]`` (L, 2) is each answer's instance."""
    a, b = numbers["problem"]["a"], numbers["problem"]["b"]
    x = np.asarray(x, dtype=np.float64)
    shift = np.asarray(data["shift"], dtype=np.float64)
    u, v = x[:, 0] - shift[:, 0], x[:, 1] - shift[:, 1]
    grad = np.stack([-2.0 * (a - u) - 4.0 * b * u * (v - u * u), 2.0 * b * (v - u * u)], axis=1)
    free = np.full(2, np.inf)
    return kkt_residuals(grad, np.zeros_like(grad), np.zeros((x.shape[0], 0)), x, -free, free, active_tol)
