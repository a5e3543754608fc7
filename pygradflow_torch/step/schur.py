"""Schur-complement step solver for block-structured KKT systems
(counterpart of ``pygradflow_tpu/step/schur.py``).

With a block-diagonal Lagrangian Hessian (contiguous ``b x b`` stage
blocks, ``params.schur_block_size``), the scaled saddle system

    [[H + lambda I   J^T ]  [sx]   [rx']
     [J             -c I ]] [sy] = [ry']

is solved by eliminating the primal block: ``A = H + lambda I`` has
explicit block inverses, the dual Schur complement
``S = -c I - J A^{-1} J^T`` (m x m) is assembled with two products, and
back-substitution takes two more.  Active variables get identity rows and
columns within their blocks, so shapes stay fixed.

Three dual paths:

- f64 dense: S by the f64 LDL^T (blocked above m = 192);
- ``PallasLDLT`` dense: f32 block inverses, assembly and elimination, S
  through the mixed-precision tier (kernel B1' up to m = 1280, the
  two-level factor above 2048) with a raw f32 back-solve, and one f64
  refinement pass on the masked saddle system;
- ``schur_dual_block_size`` (stage-local constraints): S is block
  tridiagonal, its two bands are assembled directly and factored by block
  cyclic reduction (``linalg/block_tridiag.py``), with a dense root on the
  ``PallasLDLT`` tier when it is configured (f32, refined as above).

Every operation takes a leading lane axis: with a (B,) ``lamb`` and
``rho`` the factors are (B, ...) stacks.  The block inverses, the band
einsums and the BCR levels are plain torch, as they were XLA ops in the
JAX package.
"""

from typing import Any, NamedTuple

import torch

from .. import implicit_func as impl
from ..iterate import Iterate
from ..linalg.blocked_ldlt import ldlt_factor_blocked
from ..linalg.ldlt import ldlt_factor, ldlt_solve
from ..util import lanes, matvec
from .solvers import Factorization, StepSolverDef, _lower_block


class SchurFactors(NamedTuple):
    block_inv: Any  # (..., nb, b, b) inverses of the masked A blocks
    s_fact: Any  # factor of the dual Schur complement
    jac_masked: Any  # (..., m, n) J with active columns zeroed, work dtype
    ainv_jt: Any  # (..., n, m) A^{-1} J^T, reused in back-substitution
    # (..., nb, b, b) f64 blocks of the masked primal matrix for the
    # mixed-precision refinement (None on the f64 path)
    m11_blocks: Any


def _block_diag_blocks(mat, b):
    """The contiguous (b, b) diagonal blocks (..., nb, b, b) of (..., n, n)."""
    n = mat.shape[-1]
    nb = n // b
    blocks = mat.reshape(mat.shape[:-2] + (nb, b, nb, b))
    return torch.diagonal(blocks, dim1=-4, dim2=-2).movedim(-1, -3)


def _block_inverses(blocks):
    """Explicit inverses of (..., b, b) blocks by the rank-1 LDL^T: the
    blocks are lambda-shifted Hessian blocks or identity rows, well
    conditioned by construction, and each application of A^{-1} becomes a
    batched product."""
    b = blocks.shape[-1]
    eye = torch.eye(b, dtype=blocks.dtype, device=blocks.device).expand(blocks.shape)
    return ldlt_solve(ldlt_factor(blocks), eye).mT  # row j solves C x = e_j


def _blocks_apply(block_inv, v):
    """The block-diagonal A^{-1} (..., nb, b, b) applied to vectors (..., n)."""
    nb, b = block_inv.shape[-3], block_inv.shape[-1]
    out = torch.einsum("...rij,...rj->...ri", block_inv, v.reshape(v.shape[:-1] + (nb, b)))
    return out.reshape(v.shape)


def _blocks_apply_mat(block_inv, v):
    """The block-diagonal A^{-1} applied to matrices (..., n, k)."""
    nb, b = block_inv.shape[-3], block_inv.shape[-1]
    vb = v.reshape(v.shape[:-2] + (nb, b, v.shape[-1]))
    return torch.einsum("...rij,...rjk->...rik", block_inv, vb).reshape(v.shape)


def schur_def(lin, block_size: int, dual_block=None) -> StepSolverDef:
    """``lin`` is the ``PallasLDLT`` tier for the dual Schur complement, or
    None for the f64 path; ``dual_block`` (``params.schur_dual_block_size``)
    selects the block-tridiagonal dual path."""
    b = int(block_size)
    has_pallas = lin is not None and lin.name == "pallas_ldlt"
    use_btd = dual_block is not None
    use_lin = not use_btd and has_pallas
    # mixed precision: f32 block inverses, assembly and elimination; f64
    # recovered by refinement on the masked saddle system in solve()
    mixed = has_pallas

    def factor(func: impl.StepFunc, H, J, active, rho):
        lamb = func.lamb
        n = H.shape[-1]
        m = J.shape[-2]
        dtype, device = H.dtype, H.device
        if n % b:
            raise ValueError(f"schur_block_size {b} must divide n={n}")

        Hl = H + lanes(lamb, 2) * torch.eye(n, dtype=dtype, device=device)

        # symmetric active-set masking: identity rows and columns
        inact = ~active
        both_inact = inact[..., :, None] & inact[..., None, :]
        M11 = torch.where(both_inact, Hl, 0.0) + torch.diag_embed(active.to(dtype))
        Jm = torch.where(inact[..., None, :], J, 0.0)

        work = torch.float32 if mixed else dtype
        Jmw = Jm.to(work)
        block_inv = _block_inverses(_block_diag_blocks(M11.to(work), b))
        ainv_jt = _blocks_apply_mat(block_inv, Jmw.mT)  # (..., n, m)

        if use_btd:
            # only the tridiagonal bands of S are nonzero: assemble the
            # (M, q, q) diagonal and (M-1, q, q) upper bands directly
            from ..linalg.block_tridiag import BCR_HYBRID_BASE, bcr_factor

            q = int(dual_block)
            mb = m // q
            lead = J.shape[:-2]
            jb = Jmw.reshape(lead + (mb, q, n))
            ab = ainv_jt.reshape(lead + (n, mb, q))
            mu = lamb * (1.0 / (1.0 + lamb * rho))
            mu = mu.to(work) if torch.is_tensor(mu) else mu
            eye_q = torch.eye(q, dtype=work, device=device)
            diag = -torch.einsum("...rqn,...nrp->...rqp", jb, ab) - lanes(mu, 3) * eye_q
            upper = -torch.einsum("...rqn,...nrp->...rqp", jb[..., :-1, :, :], ab[..., :, 1:, :])
            s_fact = bcr_factor(
                diag,
                upper,
                base=BCR_HYBRID_BASE if has_pallas else 8,
                root_lin=lin if has_pallas else None,
            )
        elif use_lin:
            # the diagonal block in f64, cast so that the product stays f32
            S = _lower_block(m, lamb, rho, dtype, device).to(work) - Jmw @ ainv_jt
            s_fact = lin.factor(S)
        else:
            S = _lower_block(m, lamb, rho, dtype, device) - Jm @ ainv_jt
            s_fact = ldlt_factor_blocked(S) if m > 192 else ldlt_factor(S)

        return Factorization(
            fact=SchurFactors(
                block_inv=block_inv,
                s_fact=s_fact,
                jac_masked=Jmw,
                ainv_jt=ainv_jt,
                m11_blocks=_block_diag_blocks(M11, b) if mixed else None,
            ),
            active=active,
            hess_shifted=Hl,
            jac=J,
            inertia_ok=None,
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        lamb = func.lamb
        dt = 1.0 / lamb
        pfact = 1.0 / (1.0 + lamb * rho)

        rx, ry = impl.value_at(func, it, rho, f.active)

        # condensed rhs, as the Symmetric solver: active entries pinned
        b0_full = torch.where(f.active, lanes(dt, 1) * rx, 0.0)
        rhs_x = torch.where(f.active, b0_full, rx - matvec(f.hess_shifted, b0_full))
        rhs_y = lanes(pfact, 1) * ry - matvec(f.jac, b0_full)

        sf: SchurFactors = f.fact

        def eliminate(rx_, ry_):
            """Block elimination in the factorization's working precision."""
            az = _blocks_apply(sf.block_inv, rx_)
            s_rhs = ry_ - matvec(sf.jac_masked, az)
            if use_btd:
                from ..linalg.block_tridiag import bcr_solve

                # the raw f32 root back-solve: the saddle refinement below
                # recovers f64
                root_solve = (lambda fct, b_: lin.solve(fct, b_, iters=0)) if has_pallas else None
                sy_ = bcr_solve(sf.s_fact, s_rhs, root_solve=root_solve)
            elif use_lin:
                sy_ = lin.solve(sf.s_fact, s_rhs, iters=0)
            else:
                sy_ = ldlt_solve(sf.s_fact, s_rhs)
            return az - matvec(sf.ainv_jt, sy_), sy_

        if not mixed:
            sx, sy = eliminate(rhs_x, rhs_y)
        else:
            # f32 elimination, then one f64 refinement pass on the masked
            # saddle system [[M11, Jm^T], [Jm, -mu I]]: the f32 solve is good
            # to about 1e-6 relative, and one pass gains five to six digits
            dtype = rx.dtype
            wd = sf.jac_masked.dtype

            def inner(rx_, ry_):
                sx_, sy_ = eliminate(rx_.to(wd), ry_.to(wd))
                return sx_.to(dtype), sy_.to(dtype)

            jm64 = torch.where((~f.active)[..., None, :], f.jac, 0.0)
            mu = lanes(lamb * pfact, 1)
            sx, sy = inner(rhs_x, rhs_y)
            r_x = rhs_x - _blocks_apply(sf.m11_blocks, sx) - matvec(jm64.mT, sy)
            r_y = rhs_y - matvec(jm64, sx) + mu * sy
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
    )
