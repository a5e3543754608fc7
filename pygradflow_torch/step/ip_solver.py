"""Primal-dual interior point for the proximal implicit-Euler subproblem of
the Optimizing control (counterpart of ``pygradflow_tpu/step/ip_solver.py``).

The subproblem (the reference hands it to Ipopt)::

    min_{x,w}  f(x) + rho/2 ||c(x)||^2 + lamb/2 ||x - x^||^2 + 1/2 ||w - sqrt(lamb) y^||^2
    s.t.       c(x) + sqrt(lamb) w = 0,    lb <= x <= ub

whose constraint multiplier nu is the new dual iterate.  Bound duals
``zl, zu >= 0`` with perturbed complementarity (infinite bounds masked),
``w`` eliminated, so each iteration solves one KKT system of n + m rows::

    [H + lamb I + Sigma   J^T] [dx ]   [-r_x]
    [J                -lamb I] [dnu] = [-r_g + sqrt(lamb) r_w]

then a fraction-to-boundary step and the monotone barrier update
(mu from 1e-1 down to 1e-12, divided by 5 once the error is below 10 mu).
One evaluation set (gradient, constraints, Jacobian) is carried per
iteration, which fixes the evaluation counters.

One instance or a lane stack.  The iterations end when no lane still
runs, read on the host once per iteration; a lane that has stopped keeps
its values bit for bit.  ``jnp.max(..., initial=0)`` and ``jnp.min(...,
initial=1)`` become :func:`_max0` and :func:`_min1`, which give the
initial value for an empty reduction (m = 0).
"""

import math
from typing import Any, NamedTuple

import torch

from ..util import any_running, lanes, matvec, select

IP_MAX_IT = 80
IP_TOL = 1e-8
FTB = 0.995  # fraction to the boundary
MU_INIT = 1e-1
MU_MIN = 1e-12


class IPResult(NamedTuple):
    x: Any
    nu: Any  # the constraint multiplier, the new dual iterate
    converged: Any
    iterations: Any


def _max0(v):
    """max(max over the last axis, 0), 0 for an empty axis."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return torch.clamp(torch.amax(v, dim=-1), min=0.0)


def _min1(v):
    """min(min over the last axis, 1), 1 for an empty axis."""
    if v.shape[-1] == 0:
        return torch.ones(v.shape[:-1], dtype=v.dtype, device=v.device)
    return torch.clamp(torch.amin(v, dim=-1), max=1.0)


def _sqrt(lamb):
    return torch.sqrt(lamb) if torch.is_tensor(lamb) else math.sqrt(lamb)


def solve_ip(fns, factor_solve, xhat, yhat, lamb, rho, lb, ub, tol=IP_TOL, max_it=IP_MAX_IT) -> IPResult:
    """Solve the subproblem from the proximal centre ``(xhat, yhat)``;
    ``factor_solve(K, b)`` solves with the reduced KKT matrix.  A run that
    does not converge is reported, never raised."""
    n = xhat.shape[-1]
    m = yhat.shape[-1]
    dtype, device = xhat.dtype, xhat.device
    sqrt_l = _sqrt(lamb)
    lamb1, sqrt1 = lanes(lamb, 1), lanes(sqrt_l, 1)
    has_l = torch.isfinite(lb)
    has_u = torch.isfinite(ub)

    def slacks(x):
        return torch.where(has_l, x - lb, 1.0), torch.where(has_u, ub - x, 1.0)

    def comp_at(x, zl, zu, mu):
        """The complementarity residual at barrier parameter mu."""
        sl, su = slacks(x)
        mu1 = lanes(mu, 1)
        return torch.maximum(
            _max0(torch.where(has_l, torch.abs(sl * zl - mu1), 0.0)),
            _max0(torch.where(has_u, torch.abs(su * zu - mu1), 0.0)),
        )

    def eval_set(x):
        """(constraints, Jacobian, gradient) at x."""
        return fns.cons(x), fns.cons_jac(x), fns.obj_grad(x)

    def residuals(es, x, w, nu, zl, zu):
        """The mu-independent KKT residuals from a carried evaluation set."""
        cons, jac, grad = es
        sl, su = slacks(x)
        sigma = torch.where(has_l, zl / sl, 0.0) + torch.where(has_u, zu / su, 0.0)
        grad_bnd = -torch.where(has_l, zl, 0.0) + torch.where(has_u, zu, 0.0)
        r_x = (
            grad
            + lanes(rho, 1) * matvec(jac.mT, cons)
            + lamb1 * (x - xhat)
            + matvec(jac.mT, nu)
            + grad_bnd
        )
        r_w = w - sqrt1 * yhat + sqrt1 * nu
        r_g = cons + sqrt1 * w
        err_res = torch.maximum(
            torch.amax(torch.abs(r_x), dim=-1),
            torch.maximum(_max0(torch.abs(r_w)), _max0(torch.abs(r_g))),
        )
        return r_x, r_w, r_g, sigma, err_res

    def max_step(v, dv, mask):
        neg = mask & (dv < 0.0)
        return _min1(torch.where(neg, -FTB * v / torch.where(neg, dv, -1.0), torch.inf))

    # a strictly interior start near the proximal centre
    pad = 1e-4 * torch.clamp(torch.abs(torch.where(has_l, lb, 0.0)), min=1.0)
    x0 = torch.clamp(xhat, torch.where(has_l, lb + pad, -torch.inf), torch.where(has_u, ub - pad, torch.inf))
    mu0 = torch.full(xhat.shape[:-1], MU_INIT, dtype=dtype, device=device)
    zl0 = torch.where(has_l, MU_INIT / torch.where(has_l, x0 - lb, 1.0), 0.0)
    zu0 = torch.where(has_u, MU_INIT / torch.where(has_u, ub - x0, 1.0), 0.0)
    es0 = eval_set(x0)
    if torch.is_tensor(sqrt_l):
        w0 = -es0[0] / lanes(torch.where(sqrt_l == 0.0, 1.0, sqrt_l), 1)
    else:
        w0 = -es0[0] / (1.0 if sqrt_l == 0.0 else sqrt_l)
    err0 = torch.maximum(residuals(es0, x0, w0, yhat, zl0, zu0)[-1], comp_at(x0, zl0, zu0, torch.zeros_like(mu0)))
    c = dict(x=x0, w=w0, nu=yhat, zl=zl0, zu=zu0, mu=mu0, es=es0, err=err0,
             i=torch.zeros_like(mu0, dtype=torch.int64), stalled=torch.zeros_like(mu0, dtype=torch.bool))
    eye_m = torch.eye(m, dtype=dtype, device=device)

    for _ in range(max_it):
        running = (c["err"] > tol) & ~c["stalled"]
        if not any_running(running, "ip"):
            break
        x, w, nu, zl, zu, mu, es = (c[k] for k in ("x", "w", "nu", "zl", "zu", "mu", "es"))
        r_x, r_w, r_g, sigma, err_res = residuals(es, x, w, nu, zl, zu)
        cons, jac, _ = es
        err = torch.maximum(err_res, comp_at(x, zl, zu, mu))

        # the barrier update once the inner system is solved to mu accuracy
        tighten = err <= torch.clamp(10.0 * mu, min=tol)
        mu = torch.where(tighten, torch.clamp(mu / 5.0, min=MU_MIN), mu)
        mu1 = lanes(mu, 1)

        sl, su = slacks(x)
        r_x_bar = (
            r_x
            + torch.where(has_l, zl, 0.0)
            - torch.where(has_u, zu, 0.0)
            - torch.where(has_l, mu1 / sl, 0.0)
            + torch.where(has_u, mu1 / su, 0.0)
        )
        H = fns.lag_hess(x, lanes(rho, 1) * cons + nu)
        K11 = H + lanes(rho, 2) * (jac.mT @ jac) + torch.diag_embed(lamb1 + sigma)
        lower = (-lanes(lamb, 2) * eye_m).expand(jac.shape[:-2] + (m, m))
        K = torch.cat([torch.cat([K11, jac.mT], dim=-1), torch.cat([jac, lower], dim=-1)], dim=-2)
        sol = factor_solve(K, torch.cat([-r_x_bar, -(r_g - sqrt1 * r_w)], dim=-1))
        dx, dnu = sol[..., :n], sol[..., n:]
        dw = -r_w - sqrt1 * dnu

        # the bound duals' steps from linearised complementarity
        dzl = torch.where(has_l, (mu1 - zl * dx) / sl - zl, 0.0)
        dzu = torch.where(has_u, (mu1 + zu * dx) / su - zu, 0.0)
        a_p = torch.clamp(torch.minimum(max_step(sl, dx, has_l), max_step(su, -dx, has_u)), max=1.0)
        a_d = torch.clamp(torch.minimum(max_step(zl, dzl, has_l), max_step(zu, dzu, has_u)), max=1.0)
        # a non-finite step (singular KKT) keeps the point and stalls
        finite = torch.isfinite(sol).all(dim=-1)
        a_p = torch.where(finite, a_p, 0.0)
        a_d = torch.where(finite, a_d, 0.0)
        a_p1, a_d1 = lanes(a_p, 1), lanes(a_d, 1)

        x_n = x + a_p1 * dx
        w_n = w + a_p1 * dw
        nu_n = nu + a_p1 * dnu
        zl_n = torch.where(has_l, torch.clamp(zl + a_d1 * dzl, min=MU_MIN), 0.0)
        zu_n = torch.where(has_u, torch.clamp(zu + a_d1 * dzu, min=MU_MIN), 0.0)
        es_n = eval_set(x_n)
        err_res_n = residuals(es_n, x_n, w_n, nu_n, zl_n, zu_n)[-1]
        err_n = torch.maximum(err_res_n, comp_at(x_n, zl_n, zu_n, torch.zeros_like(mu)))
        new = dict(x=x_n, w=w_n, nu=nu_n, zl=zl_n, zu=zu_n, mu=mu, es=es_n, err=err_n,
                   i=c["i"] + 1, stalled=~finite)
        c = {k: select(running, new[k], c[k]) for k in c}

    return IPResult(x=c["x"], nu=c["nu"], converged=c["err"] <= tol, iterations=c["i"])
