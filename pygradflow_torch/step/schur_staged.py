"""Matrix-free staged Schur step solver for long-horizon optimal control
(counterpart of ``pygradflow_tpu/step/schur_staged.py``).

Under the Schur tier's structure (a Lagrangian Hessian block diagonal with
``b x b`` stage blocks, and stage-local constraints: dual block ``r`` of
size ``q`` reads only stages ``r-1`` and ``r``, one dual block per stage)
the step matrix is fixed by O(N) data, found by autodiff probes instead
of dense derivatives:

- ``b`` Hessian-vector products against comb vectors (1 at position ``j``
  of every stage) give every (nb, b, b) diagonal block;
- ``2 b`` Jacobian-vector products against parity combs (1 at position
  ``j`` of every even, or every odd, stage) give the two bands
  ``Jd[r] = dc_r/dx_r`` and ``Jsub[r] = dc_r/dx_{r-1}``: adjacent stages
  have opposite parity.

Assembly, masking, the dual Schur band and the back-substitution are
(N, small, small) einsums; the band is factored by block cyclic reduction
(``linalg/block_tridiag.py``), with a dense root of 512 rows on the
``PallasLDLT`` tier (kernel B1') when it is configured, and f64 recovered
by one refinement pass on the saddle system, as in ``step/schur.py``.  The
dense Jacobian is never evaluated in the solve loop
(``iterate.evaluate_iterate`` stores a placeholder).

Every operation takes a leading lane axis.  The probes are
``torch.func.vmap`` over ``lag_hvp``/``cons_jvp``; under ``BatchedSolver``
those are the lane closures, so the probe vmap nests over the lane vmap.
"""

from typing import Any, NamedTuple

import torch
from torch.func import vmap

from .. import implicit_func as impl
from ..eval import Fns
from ..iterate import Iterate
from ..linalg.block_tridiag import BCR_HYBRID_BASE, bcr_factor, bcr_solve
from ..util import lanes
from .schur import _block_inverses, _blocks_apply
from .solvers import Factorization, StepSolverDef


class StagedFactors(NamedTuple):
    block_inv: Any  # (..., nb, b, b) work-dtype inverses of the masked blocks
    s_fact: Any  # BCRFactor of the dual Schur band
    jd_m: Any  # (..., mb, q, b) masked own-stage Jacobian band, work dtype
    jsub_m: Any  # (..., mb, q, b) masked previous-stage band, work dtype
    jd: Any  # unmasked f64 bands (for the rhs condensation)
    jsub: Any
    hl_blocks: Any  # (..., nb, b, b) unmasked H + lambda I blocks, f64
    # masked f64 data for the mixed-precision refinement (None in f64)
    m11_blocks: Any
    jd_m64: Any
    jsub_m64: Any


def _prev_stage(x, dim):
    """Element r of the stage axis ``dim`` becomes x[r-1], element 0 is
    x[0] times zero (so a non-finite value stays visible, as in JAX)."""
    return torch.cat([x.narrow(dim, 0, 1) * 0.0, x.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def _next_stage(x, dim):
    """Element r becomes x[r+1], the last one x[0] times zero."""
    return torch.cat([x.narrow(dim, 1, x.shape[dim] - 1), x.narrow(dim, 0, 1) * 0.0], dim=dim)


def _band_apply(jd, jsub, v):
    """``J v`` for the block-bidiagonal band: block ``r`` reads
    ``jd[r] x_r + jsub[r] x_{r-1}``.  ``v`` (..., n), returns (..., m)."""
    nb, b = jd.shape[-3], jd.shape[-1]
    vb = v.reshape(v.shape[:-1] + (nb, b))
    own = torch.einsum("...rqb,...rb->...rq", jd, vb)
    prev = torch.einsum("...rqb,...rb->...rq", jsub, _prev_stage(vb, -2))
    return (own + prev).reshape(v.shape[:-1] + (-1,))


def _band_t_apply(jd, jsub, w):
    """``J^T w``: stage ``s`` collects ``jd[s]^T w_s + jsub[s+1]^T
    w_{s+1}``.  ``w`` (..., m), returns (..., n)."""
    mb, q = jd.shape[-3], jd.shape[-2]
    wb = w.reshape(w.shape[:-1] + (mb, q))
    own = torch.einsum("...rqb,...rq->...rb", jd, wb)
    nxt = torch.einsum("...rqb,...rq->...rb", _next_stage(jsub, -3), _next_stage(wb, -2))
    return (own + nxt).reshape(w.shape[:-1] + (-1,))


def _extract_stage_data(fns: Fns, it: Iterate, b: int, q: int):
    """The Hessian stage blocks (..., nb, b, b) and the Jacobian bands
    (..., mb, q, b) by vmapped probes: one batched evaluation each."""
    n, m = fns.num_vars, fns.num_cons
    nb, mb = n // b, m // q
    x, y = it.x, it.y
    lead = x.shape[:-1]
    dtype, device = x.dtype, x.device

    eye_b = torch.eye(b, dtype=dtype, device=device)
    combs = eye_b.repeat(1, nb)  # (b, n): 1 at position j of each stage

    def probe(f, vs):
        """``f(v)`` for each probe of ``vs`` (p, n), each lane its own copy;
        the probe axis moved behind the lane axes."""
        out = vmap(f)(vs.reshape((-1,) + (1,) * len(lead) + (n,)).expand((-1,) + lead + (n,)))
        return out.movedim(0, len(lead))

    hcols = probe(lambda v: fns.lag_hvp(x, y, v), combs)  # (..., b, n)
    # hcols[j, r*b + i] = H[r*b + i, r*b + j]
    hblocks = hcols.reshape(lead + (b, nb, b)).movedim(-3, -1)

    par = (torch.arange(nb, device=device) % 2).to(dtype)
    stage_combs = combs.reshape(b, nb, b)
    probes = torch.stack(
        [
            (stage_combs * (1.0 - par)[None, :, None]).reshape(b, n),
            (stage_combs * par[None, :, None]).reshape(b, n),
        ]
    )  # (2, b, n): even-stage combs, odd-stage combs
    jcols = probe(lambda v: fns.cons_jvp(x, v), probes.reshape(2 * b, n))
    # jc[..., r, p, j, i] = J[row i of block r, position j of the parity-p
    # stage it touches]; the own stage of block r has parity r % 2
    jc = jcols.reshape(lead + (2, b, mb, q)).movedim(-2, -4)
    ridx = torch.arange(mb, device=device)
    rpar = ridx % 2
    jd = jc[..., ridx, rpar, :, :].mT  # (..., mb, q, b)
    jsub = jc[..., ridx, 1 - rpar, :, :].mT
    # block 0 reads stage 0 only
    jsub = torch.cat([jsub[..., :1, :, :] * 0.0, jsub[..., 1:, :, :]], dim=-3)
    return hblocks, jd, jsub


def schur_staged_def(lin, fns: Fns, block_size: int, dual_block: int) -> StepSolverDef:
    """Matrix-free staged Schur ``StepSolverDef``; ``lin`` is the
    ``PallasLDLT`` tier for the BCR root, or None for pure f64."""
    b = int(block_size)
    q = int(dual_block)
    n, m = fns.num_vars, fns.num_cons
    if n % b or m % q or n // b != m // q:
        raise ValueError(
            f"staged Schur needs one dual block of size {q} per stage of size {b} "
            f"(got n={n}, m={m})"
        )
    nb = n // b
    mixed = lin is not None and lin.name == "pallas_ldlt"

    def factor(func: impl.StepFunc, it: Iterate, active, rho):
        lamb = func.lamb
        dtype, device = it.x.dtype, it.x.device
        lead = it.x.shape[:-1]
        eye_b = torch.eye(b, dtype=dtype, device=device)

        hblocks, jd, jsub = _extract_stage_data(fns, it, b, q)
        hl = hblocks + lanes(lamb, 3) * eye_b

        # symmetric active-set masking within the stages
        inact = (~active).reshape(lead + (nb, b))
        act = active.reshape(lead + (nb, b))
        both = inact[..., :, :, None] & inact[..., :, None, :]
        m11 = torch.where(both, hl, 0.0) + eye_b * act[..., :, None, :].to(dtype)

        jd_m64 = torch.where(inact[..., :, None, :], jd, 0.0)
        prev_inact = torch.cat([torch.zeros_like(inact[..., :1, :]), inact[..., :-1, :]], dim=-2)
        jsub_m64 = torch.where(prev_inact[..., :, None, :], jsub, 0.0)

        work = torch.float32 if mixed else dtype
        block_inv = _block_inverses(m11.to(work))
        jdw = jd_m64.to(work)
        jsw = jsub_m64.to(work)

        # the dual Schur band: S_rr = -mu I - (Jd_r Ainv_r Jd_r^T
        # + Jsub_r Ainv_{r-1} Jsub_r^T), S_{r,r+1} = -Jd_r Ainv_r Jsub_{r+1}^T
        mu = lamb * (1.0 / (1.0 + lamb * rho))
        mu = mu.to(work) if torch.is_tensor(mu) else mu
        ainv_prev = _prev_stage(block_inv, -3)
        t_own = torch.einsum("...rqb,...rbc,...rpc->...rqp", jdw, block_inv, jdw)
        t_sub = torch.einsum("...rqb,...rbc,...rpc->...rqp", jsw, ainv_prev, jsw)
        diag = -(t_own + t_sub) - lanes(mu, 3) * torch.eye(q, dtype=work, device=device)
        upper = -torch.einsum(
            "...rqb,...rbc,...rpc->...rqp",
            jdw[..., :-1, :, :], block_inv[..., :-1, :, :], jsw[..., 1:, :, :],
        )

        s_fact = bcr_factor(
            diag,
            upper,
            base=BCR_HYBRID_BASE if mixed else 8,
            root_lin=lin if mixed else None,
        )
        return Factorization(
            fact=StagedFactors(
                block_inv=block_inv,
                s_fact=s_fact,
                jd_m=jdw,
                jsub_m=jsw,
                jd=jd,
                jsub=jsub,
                hl_blocks=hl,
                m11_blocks=m11 if mixed else None,
                jd_m64=jd_m64 if mixed else None,
                jsub_m64=jsub_m64 if mixed else None,
            ),
            active=active,
            hess_shifted=None,  # the banded data lives in fact
            jac=None,
            inertia_ok=None,
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        lamb = func.lamb
        dt = 1.0 / lamb
        pfact = 1.0 / (1.0 + lamb * rho)
        sf: StagedFactors = f.fact

        rx, ry = impl.value_at(func, it, rho, f.active, fns=fns)
        dtype = rx.dtype

        # condensed rhs, as in schur.py, with banded operators
        b0_full = torch.where(f.active, lanes(dt, 1) * rx, 0.0)
        rhs_x = torch.where(f.active, b0_full, rx - _blocks_apply(sf.hl_blocks, b0_full))
        rhs_y = lanes(pfact, 1) * ry - _band_apply(sf.jd, sf.jsub, b0_full)

        root_solve = (lambda fct, b_: lin.solve(fct, b_, iters=0)) if mixed else None

        def eliminate(rx_, ry_):
            az = _blocks_apply(sf.block_inv, rx_)
            s_rhs = ry_ - _band_apply(sf.jd_m, sf.jsub_m, az)
            sy_ = bcr_solve(sf.s_fact, s_rhs, root_solve=root_solve)
            jt_sy = _band_t_apply(sf.jd_m, sf.jsub_m, sy_)
            return az - _blocks_apply(sf.block_inv, jt_sy), sy_

        if not mixed:
            sx, sy = eliminate(rhs_x, rhs_y)
        else:
            wd = sf.jd_m.dtype

            def inner(rx_, ry_):
                sx_, sy_ = eliminate(rx_.to(wd), ry_.to(wd))
                return sx_.to(dtype), sy_.to(dtype)

            # one f64 refinement pass on the masked saddle system, every
            # residual term banded
            mu = lanes(lamb * pfact, 1)
            sx, sy = inner(rhs_x, rhs_y)
            r_x = (
                rhs_x
                - _blocks_apply(sf.m11_blocks, sx)
                - _band_t_apply(sf.jd_m64, sf.jsub_m64, sy)
            )
            r_y = rhs_y - _band_apply(sf.jd_m64, sf.jsub_m64, sx) + mu * sy
            cx, cy = inner(r_x, r_y)
            sx = sx + cx
            sy = sy + cy

        dx = sx
        dy = lanes(pfact, 1) * (sy - lanes(rho, 1) * ry)
        return dx, dy

    return StepSolverDef(
        scaled=True,
        symmetric=True,
        hess_rho_is_runtime=False,
        factor=factor,
        solve=solve,
        matrix_free=True,
    )
