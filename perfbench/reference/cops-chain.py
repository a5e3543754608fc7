"""Plain reference of the ``cops-chain`` configuration, in float64 on the
CPU: the hanging chain's objective gradient, constraints and J^T y of
each answer written out by hand against its own (a, b, L) = published +
delta, for the optimality measure of ``kkt.kkt_residuals``.

Variables [u, x1, x2, x3] (each on the nh + 1 grid points t_k = k / nh);
constraints [d1, d2, d3, ends], with for j = 0..nh-1 and h = 1 / nh

    d1_j = x1_{j+1} - x1_j - h/2 (u_{j+1} + u_j)
    d2_j = x2_{j+1} - x2_j - h/2 (x1_{j+1} s_{j+1} + x1_j s_j)
    d3_j = x3_{j+1} - x3_j - h/2 (s_{j+1} + s_j),      s = sqrt(1 + u^2)

and ends = [x1_0 - a, x1_nh - b, x2_0, x3_0, x3_nh - L]."""

import numpy as np
import torch

from reference.kkt import kkt_residuals

torch.backends.cuda.matmul.allow_tf32 = False


def _split(x, nh):
    k = nh + 1
    return x[:, :k], x[:, k : 2 * k], x[:, 2 * k : 3 * k], x[:, 3 * k :]


def constraints(x, delta, numbers, nh):
    """c(x) (L, 3 nh + 5) of the answers ``x`` (L, 4 (nh + 1)) for each
    row's own ``delta`` (L, 3)."""
    p = numbers["problem"]
    half = 0.5 / nh
    u, x1, x2, x3 = _split(x, nh)
    s = torch.sqrt(1.0 + u * u)
    d1 = x1[:, 1:] - x1[:, :-1] - half * (u[:, 1:] + u[:, :-1])
    d2 = x2[:, 1:] - x2[:, :-1] - half * (x1[:, 1:] * s[:, 1:] + x1[:, :-1] * s[:, :-1])
    d3 = x3[:, 1:] - x3[:, :-1] - half * (s[:, 1:] + s[:, :-1])
    ends = torch.stack([x1[:, 0] - (p["a"] + delta[:, 0]), x1[:, -1] - (p["b"] + delta[:, 1]), x2[:, 0], x3[:, 0],
                        x3[:, -1] - (p["L"] + delta[:, 2])], dim=1)
    return torch.cat([d1, d2, d3, ends], dim=1)


def gradient(x, nh):
    """grad f (L, n): f = x2(1), a unit vector at x2_nh."""
    g = torch.zeros_like(x)
    g[:, 3 * (nh + 1) - 1] = 1.0
    return g


def _to_points(w):
    """(L, nh) weights of the intervals -> (L, nh + 1) at the grid points:
    w_{k-1} + w_k, each end taking its one interval."""
    zero = torch.zeros_like(w[:, :1])
    return torch.cat([w, zero], dim=1) + torch.cat([zero, w], dim=1)


def _difference(w):
    """(L, nh) -> (L, nh + 1): the derivative of sum_j w_j (z_{j+1} - z_j)
    by z_k, w_{k-1} - w_k."""
    zero = torch.zeros_like(w[:, :1])
    return torch.cat([zero, w], dim=1) - torch.cat([w, zero], dim=1)


def jac_t_y(x, y, nh):
    """J(x)^T y (L, n) for the multipliers ``y`` (L, 3 nh + 5)."""
    half = 0.5 / nh
    u, x1, _, _ = _split(x, nh)
    s = torch.sqrt(1.0 + u * u)
    y1, y2, y3, ends = y[:, :nh], y[:, nh : 2 * nh], y[:, 2 * nh : 3 * nh], y[:, 3 * nh :]
    ds = u / s  # d s / d u
    gu = -half * (_to_points(y1) + _to_points(y2) * x1 * ds + _to_points(y3) * ds)
    g1 = _difference(y1) - half * _to_points(y2) * s
    g2 = _difference(y2)
    g3 = _difference(y3)
    g1[:, 0] += ends[:, 0]
    g1[:, -1] += ends[:, 1]
    g2[:, 0] += ends[:, 2]
    g3[:, 0] += ends[:, 3]
    g3[:, -1] += ends[:, 4]
    return torch.cat([gu, g1, g2, g3], dim=1)


def residuals(x, y, data, numbers, size, active_tol):
    """``kkt.kkt_residuals`` of the answers ``x`` (L, n) with multipliers
    ``y`` (L, m); ``data["delta"]`` (L, 3) is each answer's instance."""
    nh = size["nh"]
    x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    y = torch.as_tensor(np.asarray(y, dtype=np.float64))
    delta = torch.as_tensor(np.asarray(data["delta"], dtype=np.float64))
    free = np.full(x.shape[1], np.inf)
    return kkt_residuals(gradient(x, nh).numpy(), jac_t_y(x, y, nh).numpy(), constraints(x, delta, numbers, nh).numpy(),
                         x.numpy(), -free, free, active_tol)
