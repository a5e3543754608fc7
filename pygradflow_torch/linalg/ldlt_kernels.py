"""The two hand-written Hopper LDL^T kernels, their plain versions, and the
mixed-precision solve.

- :func:`ldlt_factor_rl`: right-looking, NB = 128 (``csrc/ldlt.cu``),
  counterpart of ``pygradflow_tpu/linalg/pallas_ldlt.py::pallas_ldlt_factor_f32``.
- :func:`ldlt_factor_ll`: left-looking, NB = 64, counterpart of
  ``pygradflow_tpu/linalg/pallas_ldlt_hbm.py::pallas_ldlt_factor_hbm``.

Both take an (n, n) f32 matrix, pad it with identity to a multiple of NB and
return the packed factor (n, n): strict lower triangle = unit L, diagonal =
D; a zero pivot becomes NaN.  A CUDA tensor launches the kernel (or
raises); a CPU tensor runs the plain PyTorch version, ``*_ref``, which runs
the same algorithm with the same panel width and is what the kernel is held
against on the card.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels.
"""

import ctypes

import torch

RL_BLOCK = 128
LL_BLOCK = 64

LAUNCHES = {"rl": 0, "ll": 0}


def _padded_size(n: int, block: int) -> int:
    return -(-n // block) * block


def _pad_identity(mat, block):
    n = mat.shape[-1]
    n_pad = _padded_size(n, block)
    out = torch.eye(n_pad, dtype=mat.dtype, device=mat.device)
    out[:n, :n] = mat
    return out


def _factor_panel_ref(a, base, block):
    """NB sequential rank-1 column steps on the panel ``a[base:, base:base+NB]``
    in place: each step's multiply and subtract round separately, as in the
    TPU kernel's ``_factor_body``."""
    p = a[base:, base : base + block]
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    for j in range(block):
        d = p[j, j]
        inv = torch.where(d != 0.0, 1.0 / d, nan)
        col = p[j + 1 :, j] * inv
        p[j + 1 :, j + 1 :] -= col[:, None] * p[j, j + 1 :][None, :]
        p[j + 1 :, j] = col


def ldlt_factor_rl_ref(mat):
    """Plain version of the right-looking kernel: per panel, NB column steps
    over the panel's full height, then the trailing update
    A -= (L_p D_p) L_p^T on the rows and columns after the panel."""
    n = mat.shape[-1]
    a = _pad_identity(mat, RL_BLOCK)
    n_pad = a.shape[-1]
    for base in range(0, n_pad, RL_BLOCK):
        _factor_panel_ref(a, base, RL_BLOCK)
        e = base + RL_BLOCK
        if e < n_pad:
            lp = a[e:, base:e]
            d = torch.diagonal(a[base:e, base:e])
            a[e:, e:] -= (lp * d) @ lp.T
    return a[:n, :n]


def ldlt_factor_ll_ref(mat):
    """Plain version of the left-looking kernel: per panel j, the update
    P -= L_{:,<j} (L_{j,<j} D_{<j})^T from every earlier panel, then the
    same column steps as the right-looking version."""
    n = mat.shape[-1]
    a = _pad_identity(mat, LL_BLOCK)
    n_pad = a.shape[-1]
    diag = torch.diagonal(a)
    for base in range(0, n_pad, LL_BLOCK):
        e = base + LL_BLOCK
        if base > 0:
            m = a[base:e, :base] * diag[:base]
            a[base:, base:e] -= a[base:, :base] @ m.T
        _factor_panel_ref(a, base, LL_BLOCK)
    return a[:n, :n]


def _check(mat, name):
    if mat.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {mat.dtype}")
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1] or mat.shape[0] == 0:
        raise ValueError(f"{name}: expected a non-empty square matrix, got {tuple(mat.shape)}")
    if not mat.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous matrix")


def _launch(key, fn_name, mat, block):
    from ..build import load_library

    lib = load_library()
    n = mat.shape[-1]
    n_pad = _padded_size(n, block)
    out = torch.empty((n_pad, n_pad), dtype=torch.float32, device=mat.device)
    stream = torch.cuda.current_stream(mat.device).cuda_stream
    with torch.cuda.device(mat.device):
        err = getattr(lib, fn_name)(
            ctypes.c_void_p(mat.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            n,
            n_pad,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err}")
    LAUNCHES[key] += 1
    return out[:n, :n]


def _dispatch(mat, key, fn_name, block, ref):
    _check(mat, fn_name)
    if mat.device.type == "cpu":
        return ref(mat)
    if mat.device.type != "cuda":
        raise ValueError(f"{fn_name}: no kernel for device {mat.device}")
    return _launch(key, fn_name, mat, block)


def ldlt_factor_rl(mat):
    """Packed f32 LDL^T, right-looking kernel (CUDA) or its plain version (CPU)."""
    return _dispatch(mat, "rl", "pgf_ldlt_factor_rl", RL_BLOCK, ldlt_factor_rl_ref)


def ldlt_factor_ll(mat):
    """Packed f32 LDL^T, left-looking kernel (CUDA) or its plain version (CPU)."""
    return _dispatch(mat, "ll", "pgf_ldlt_factor_ll", LL_BLOCK, ldlt_factor_ll_ref)


def refine_solve(packed_f32, mat_f64, rhs, iters: int = 3):
    """Mixed-precision solve: f32 LDL^T back-solves, then ``iters`` f64
    residual-refinement passes against the f64 matrix."""
    from .ldlt import ldlt_solve

    def solve32(r):
        return ldlt_solve(packed_f32, r.to(torch.float32)).to(rhs.dtype)

    x = solve32(rhs)
    for _ in range(iters):
        x = x + solve32(rhs - mat_f64 @ x)
    return x
