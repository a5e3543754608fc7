"""MINRES for symmetric (indefinite) systems (counterpart of
``pygradflow_tpu/linalg/minres.py``).

The Paige-Saunders Lanczos/Givens recurrence with a warm start ``x0``.
The JAX package stops at the exact iteration through ``lax.while_loop``.
Here the loop body is masked: an iteration that starts with ``done`` set
leaves every carried value as it was, and ``done`` is read on the host
only every ``check_every`` iterations.  The result is therefore bitwise
independent of ``check_every``.  The same body serves one system (b of
shape (n,)) and a lane stack (b of shape (B, n) against a (B, n, n)
stack), where each lane freezes on its own ``done``.
"""

import torch

from ..util import any_running, dot, lanes, matvec

CHECK_EVERY = 16
"""Iterations between two host reads of ``done``."""


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def minres(A, b, x0=None, tol=1e-12, maxiter=None, check_every=CHECK_EVERY):
    """Solve ``A x = b`` for symmetric ``A`` (a matrix, a stack or a
    callable matvec); ``maxiter`` defaults to 4 n."""
    mv = A if callable(A) else (lambda v: matvec(A, v))
    n = b.shape[-1]
    if maxiter is None:
        maxiter = 4 * n
    eps = torch.finfo(b.dtype).eps

    x = torch.zeros_like(b) if x0 is None else x0
    r1 = b - mv(x)
    beta1 = _norm(r1)
    thresh = tol * torch.clamp(_norm(b), min=1.0)
    zero = torch.zeros_like(beta1)
    c = dict(
        x=x, y=r1, r1=r1, r2=r1, oldb=zero, beta=beta1, dbar=zero, epsln=zero,
        phibar=beta1, cs=-torch.ones_like(beta1), sn=zero,
        w=torch.zeros_like(b), w2=torch.zeros_like(b),
    )
    done = beta1 <= thresh

    for itn in range(1, maxiter + 1):
        if (itn - 1) % check_every == 0 and not any_running(~done, "minres"):
            break
        beta = c["beta"]
        safe_beta = torch.where(beta == 0.0, 1.0, beta)
        v = c["y"] / lanes(safe_beta, 1)
        y = mv(v)
        if itn >= 2:
            safe_oldb = torch.where(c["oldb"] == 0.0, 1.0, c["oldb"])
            y = y - lanes(beta / safe_oldb, 1) * c["r1"]
        alfa = dot(v, y)
        y = y - lanes(alfa / safe_beta, 1) * c["r2"]
        beta_new = _norm(y)

        # the previous Givens rotation on the new column of the tridiagonal
        oldeps = c["epsln"]
        delta = c["cs"] * c["dbar"] + c["sn"] * alfa
        gbar = c["sn"] * c["dbar"] - c["cs"] * alfa
        epsln = c["sn"] * beta_new
        dbar = -c["cs"] * beta_new

        # the rotation that annihilates beta_new
        gamma = torch.clamp(torch.sqrt(gbar**2 + beta_new**2), min=eps)
        cs = gbar / gamma
        sn = beta_new / gamma
        phi = cs * c["phibar"]
        phibar = sn * c["phibar"]

        w1, w2 = c["w2"], c["w"]
        w = (v - lanes(oldeps, 1) * w1 - lanes(delta, 1) * w2) / lanes(gamma, 1)
        new = dict(
            x=c["x"] + lanes(phi, 1) * w, y=y, r1=c["r2"], r2=y, oldb=beta, beta=beta_new,
            dbar=dbar, epsln=epsln, phibar=phibar, cs=cs, sn=sn, w=w, w2=w2,
        )
        c = {k: torch.where(lanes(done, val.ndim - done.ndim), c[k], val) for k, val in new.items()}
        done = done | (phibar <= thresh) | ~torch.isfinite(phibar)
    return c["x"]
