"""The hand-written Hopper LDL^T kernels, their plain versions, and the
mixed-precision solve.

- :func:`ldlt_factor_rl`: right-looking, NB = 128 (``csrc/ldlt.cu``),
  counterpart of ``pygradflow_tpu/linalg/pallas_ldlt.py::pallas_ldlt_factor_f32``.
- :func:`ldlt_factor_rl_batched`: the same factor for each matrix of a
  (B, n, n) stack in one launch per kernel per panel, counterpart of the
  batched kernel ``pallas_ldlt.py::_batched_kernel``.
- :func:`ldlt_factor_ll`: left-looking, NB = 64, counterpart of
  ``pygradflow_tpu/linalg/pallas_ldlt_hbm.py::pallas_ldlt_factor_hbm``.

Each pads its matrices with identity to a multiple of NB and returns the
packed factors at the input's shape: strict lower triangle = unit L,
diagonal = D; a zero pivot becomes NaN.  A CUDA tensor launches the kernel
(or raises); a CPU tensor runs the plain PyTorch version, ``*_ref``, which
runs the same algorithm with the same panel width and is what the kernel is
held against on the card.

The left-looking kernel splits its update products over K and sums the
partial tiles in a workspace that its wrapper allocates per call.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels.  A wrapper called while the solve
loop's iteration is captured as a CUDA graph records its launch on the
capture stream (``torch.cuda.current_stream``), and its workspace and
output come from the graph's memory pool.  It counts its launch there too:
``util.count_launch`` captures an add on a device counter beside the
kernel, so every replayed body counts it, and the loop's one read per
chunk brings the count to ``LAUNCHES``.
"""

import ctypes

import torch

from ..util import count_launch, register_launches

RL_BLOCK = 128
LL_BLOCK = 64

LAUNCHES = {"rl": 0, "ll": 0, "rl_batched": 0}
register_launches(LAUNCHES)

REFINED = {"solves": 0, "sweeps": 0}
"""The mixed-precision solves of ``refine_solve``: ``solves``, one per
call (one system or one stack), and ``sweeps``, one per residual sweep in
the matrix's own dtype.  Counted as the launches are (``count_launch``),
so a call inside a captured body counts at every replay.  Apart from
``LAUNCHES``, whose every key is a factor."""
register_launches(REFINED)


def _padded_size(n: int, block: int) -> int:
    return -(-n // block) * block


def pad_identity(mat, block):
    """``mat`` (..., n, n) padded with identity to a multiple of ``block``."""
    n = mat.shape[-1]
    n_pad = _padded_size(n, block)
    if n_pad == n:
        return mat.clone()
    eye = torch.eye(n_pad, dtype=mat.dtype, device=mat.device)
    out = eye.expand(mat.shape[:-2] + (n_pad, n_pad)).clone()
    out[..., :n, :n] = mat
    return out


def _factor_panel_ref(a, base, block):
    """NB sequential rank-1 column steps on the panel
    ``a[..., base:, base:base+NB]`` in place: each step's multiply and
    subtract round separately, as in the TPU kernel's ``_factor_body``."""
    p = a[..., base:, base : base + block]
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    for j in range(block):
        d = p[..., j, j]
        inv = torch.where(d != 0.0, 1.0 / d, nan)
        col = p[..., j + 1 :, j] * inv[..., None]
        p[..., j + 1 :, j + 1 :] -= col[..., :, None] * p[..., j, None, j + 1 :]
        p[..., j + 1 :, j] = col


def ldlt_factor_rl_ref(mat):
    """Plain version of the right-looking kernel on (..., n, n): per panel,
    NB column steps over the panel's full height, then the trailing update
    A -= (L_p D_p) L_p^T on the rows and columns after the panel."""
    n = mat.shape[-1]
    a = pad_identity(mat, RL_BLOCK)
    n_pad = a.shape[-1]
    for base in range(0, n_pad, RL_BLOCK):
        _factor_panel_ref(a, base, RL_BLOCK)
        e = base + RL_BLOCK
        if e < n_pad:
            lp = a[..., e:, base:e]
            d = torch.diagonal(a[..., base:e, base:e], dim1=-2, dim2=-1)
            a[..., e:, e:] -= (lp * d[..., None, :]) @ lp.mT
    return a[..., :n, :n]


def ldlt_factor_rl_batched_ref(mat):
    """Plain version of the batched kernel: the right-looking plain version
    over the leading dimension."""
    return ldlt_factor_rl_ref(mat)


def ldlt_factor_ll_ref(mat):
    """Plain version of the left-looking kernel: per panel j, the update
    P -= L_{:,<j} (L_{j,<j} D_{<j})^T from every earlier panel, then the
    same column steps as the right-looking version."""
    n = mat.shape[-1]
    a = pad_identity(mat, LL_BLOCK)
    n_pad = a.shape[-1]
    diag = torch.diagonal(a)
    for base in range(0, n_pad, LL_BLOCK):
        e = base + LL_BLOCK
        if base > 0:
            m = a[base:e, :base] * diag[:base]
            a[base:, base:e] -= a[base:, :base] @ m.T
        _factor_panel_ref(a, base, LL_BLOCK)
    return a[:n, :n]


MAX_BATCH = 65535  # the kernels carry the instance in gridDim.z


def _check(mat, name, ndim):
    if mat.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {mat.dtype}")
    what = "square matrix" if ndim == 2 else "stack of square matrices"
    if mat.ndim != ndim or mat.shape[-1] != mat.shape[-2] or 0 in mat.shape:
        raise ValueError(f"{name}: expected a non-empty {what}, got {tuple(mat.shape)}")
    if ndim == 3 and mat.shape[0] > MAX_BATCH:
        raise ValueError(f"{name}: batch {mat.shape[0]} > {MAX_BATCH}")
    if not mat.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous matrix")


def _workspace(lib, n_pad, device):
    """The left-looking kernel's split-K workspace (partial tiles and their
    counters), as many bytes as the library asks for at ``n_pad``."""
    size = ctypes.c_longlong()
    err = lib.pgf_ldlt_factor_ll_workspace(n_pad, ctypes.byref(size))
    if err != 0:
        raise RuntimeError(f"pgf_ldlt_factor_ll_workspace failed with CUDA error {err}")
    work = torch.empty(size.value, dtype=torch.uint8, device=device)
    return work, (ctypes.c_void_p(work.data_ptr()), ctypes.c_longlong(size.value))


def _launch(key, fn_name, mat, block):
    from ..build import load_library

    lib = load_library()
    lead = tuple(mat.shape[:-2])
    n = mat.shape[-1]
    n_pad = _padded_size(n, block)
    out = torch.empty(lead + (n_pad, n_pad), dtype=torch.float32, device=mat.device)
    stream = torch.cuda.current_stream(mat.device).cuda_stream
    with torch.cuda.device(mat.device):
        work, work_args = _workspace(lib, n_pad, mat.device) if key == "ll" else (None, ())
        err = getattr(lib, fn_name)(
            ctypes.c_void_p(mat.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            *work_args,
            *lead,
            n,
            n_pad,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err}")
    count_launch(LAUNCHES, key, mat.device)
    return out[..., :n, :n]


def _dispatch(mat, key, fn_name, block, ref, ndim=2):
    _check(mat, fn_name, ndim)
    if mat.device.type == "cpu":
        return ref(mat)
    if mat.device.type != "cuda":
        raise ValueError(f"{fn_name}: no kernel for device {mat.device}")
    return _launch(key, fn_name, mat, block)


def ldlt_factor_rl(mat):
    """Packed f32 LDL^T, right-looking kernel (CUDA) or its plain version (CPU)."""
    return _dispatch(mat, "rl", "pgf_ldlt_factor_rl", RL_BLOCK, ldlt_factor_rl_ref)


def ldlt_factor_rl_batched(mat):
    """Packed f32 LDL^T of each matrix of a (B, n, n) stack, batched
    right-looking kernel (CUDA) or its plain version (CPU)."""
    return _dispatch(
        mat, "rl_batched", "pgf_ldlt_factor_rl_batched", RL_BLOCK,
        ldlt_factor_rl_batched_ref, ndim=3,
    )


def ldlt_factor_ll(mat):
    """Packed f32 LDL^T, left-looking kernel (CUDA) or its plain version (CPU)."""
    return _dispatch(mat, "ll", "pgf_ldlt_factor_ll", LL_BLOCK, ldlt_factor_ll_ref)


def refine_solve(packed_f32, mat_f64, rhs, iters: int = 3):
    """Mixed-precision solve: f32 LDL^T back-solves, then ``iters``
    residual-refinement passes against the matrix in its own dtype: f64, or
    f32 under ``Precision.Single``, as ``pallas_ldlt.py:243-257`` computes
    it.  Takes one system or a stack: ``rhs`` is (..., n) against
    (..., n, n)."""
    from ..util import matvec
    from .ldlt import ldlt_solve

    def solve32(r):
        return ldlt_solve(packed_f32, r.to(torch.float32)).to(rhs.dtype)

    count_launch(REFINED, "solves", rhs.device)
    if iters:
        count_launch(REFINED, "sweeps", rhs.device, iters)
    x = solve32(rhs)
    for _ in range(iters):
        x = x + solve32(rhs - matvec(mat_f64, x))
    return x
