"""Discretized optimal-control NLP (counterpart of
``pygradflow_tpu/runners/control.py``): the pendulum swing-up, flat layout.
"""

import math

import numpy as np
import torch

from ..problem import Problem


class PendulumControl(Problem):
    """Swing-up of a damped pendulum.

    States (theta, omega), control torque u with |u| <= u_max.
    Dynamics: theta' = omega; omega' = -sin(theta) - c*omega + u.
    Objective: sum_k h * (w1*(theta_k - pi)^2 + w2*omega_k^2 + alpha*u_k^2).
    Variables: [theta_0..theta_N, omega_0..omega_N, u_0..u_{N-1}],
    n = 2(N+1) + N; equality constraints: initial conditions + N Euler
    steps for each state, m = 2(N+1).
    """

    def __init__(self, N: int = 32, h: float = 0.1, u_max: float = 2.5, alpha=1e-2):
        self.N = N
        self.h = h
        self.alpha = alpha

        n_states = 2 * (N + 1)
        n = n_states + N

        lb = np.full(n, -np.inf)
        ub = np.full(n, np.inf)
        lb[n_states:] = -u_max
        ub[n_states:] = u_max

        super().__init__(lb, ub, num_cons=2 * (N + 1))

    def _split(self, z):
        N = self.N
        return z[: N + 1], z[N + 1 : 2 * (N + 1)], z[2 * (N + 1) :]

    def obj(self, z):
        theta, omega, u = self._split(z)
        track = torch.sum((theta - math.pi) ** 2) + 0.1 * torch.sum(omega**2)
        effort = self.alpha * torch.sum(u**2)
        return self.h * (track + effort)

    def cons(self, z):
        theta, omega, u = self._split(z)
        h = self.h
        c = 0.2  # damping

        # explicit Euler dynamics residuals
        dtheta = theta[1:] - theta[:-1] - h * omega[:-1]
        domega = omega[1:] - omega[:-1] - h * (-torch.sin(theta[:-1]) - c * omega[:-1] + u)

        # initial conditions theta_0 = 0, omega_0 = 0
        init = torch.stack([theta[0], omega[0]])
        return torch.cat([init, dtheta, domega])

    def x0_trajectory(self):
        """A feasible-ish warm start: linear sweep to the target (numpy)."""
        N = self.N
        theta = np.linspace(0.0, np.pi, N + 1)
        return np.concatenate([theta, np.zeros(N + 1), np.zeros(N)])
