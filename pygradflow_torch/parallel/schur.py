"""Distributed Schur-complement KKT solve over several devices (counterpart
of ``pygradflow_tpu/parallel/schur.py``).

The block-diagonal primal blocks and the matching Jacobian column slices
are split over the mesh's devices.  Each shard inverts its blocks and forms
its share of ``J A^{-1} J^T`` and ``J A^{-1} r_x``; the shares are summed
on the first device (the JAX package's ``psum``), which factors the dense
dual Schur complement; each shard then back-substitutes its primal rows.
"""

from typing import Optional, Sequence

import torch

from ..linalg.ldlt import ldlt_factor, ldlt_solve
from ..step.schur import _block_inverses
from .shard import resolve_mesh, run_per_device


def distributed_schur_solve(
    h_blocks,  # (nb, b, b) primal diagonal blocks (already shifted/masked)
    jac,  # (m, n) dual coupling, n = nb * b
    m22,  # (m, m) dual block (e.g. -lambda/(1+lambda rho) I)
    rhs_x,  # (n,)
    rhs_y,  # (m,)
    mesh: Optional[Sequence] = None,
):
    """Solve ``[[A, J^T], [J, M22]] [sx, sy] = [rhs_x, rhs_y]`` with ``A``
    block diagonal, the block axis split over ``mesh`` (default: every
    visible CUDA device).  Returns ``(sx, sy)`` on the mesh's first device."""
    mesh = resolve_mesh(mesh)
    nb, b, _ = h_blocks.shape
    n = nb * b
    nd = len(mesh)
    if nb % nd != 0:
        raise ValueError(f"number of blocks {nb} must divide over {nd} devices")
    per = nb // nd
    home = mesh[0]

    # J and rhs_x in per-block form, so that one axis splits them all
    jac_b = jac.reshape(-1, nb, b).transpose(0, 1)  # (nb, m, b)
    rhs_xb = rhs_x.reshape(nb, b)
    shards = [slice(k * per, (k + 1) * per) for k in range(nd)]

    def local_terms(k, rows):
        device = mesh[k]
        h, jb, rx = (t[rows].to(device) for t in (h_blocks, jac_b, rhs_xb))
        inv = _block_inverses(h)
        ainv_jt = torch.einsum("kij,kmj->kmi", inv, jb)  # (nb/D, m, b)
        az = torch.einsum("kij,kj->ki", inv, rx)  # (nb/D, b)
        s_local = torch.einsum("kmb,knb->mn", jb, ainv_jt)
        jaz_local = torch.einsum("kmb,kb->m", jb, az)
        return ainv_jt, az, s_local, jaz_local

    terms = run_per_device(mesh, local_terms, shards)

    # the sum over shards in shard order on the first device, then the dual
    # solve there
    s_sum = sum(t[2].to(home) for t in terms)
    jaz = sum(t[3].to(home) for t in terms)
    S = m22.to(home) - s_sum
    sy = ldlt_solve(ldlt_factor(S), rhs_y.to(home) - jaz)

    def back_substitute(k, term):
        ainv_jt, az = term[0], term[1]
        return az - torch.einsum("kmb,m->kb", ainv_jt, sy.to(mesh[k]))

    sx = run_per_device(mesh, back_substitute, terms)
    return torch.cat([s.to(home) for s in sx]).reshape(n), sy
