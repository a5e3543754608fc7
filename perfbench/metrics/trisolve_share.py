"""trisolve_share (linear solve: linalg/ldlt.py ``ldlt_solve``, called by
``ldlt_kernels.refine_solve`` for the f32 back-solves of each refined KKT
solve): the device time of the triangular-solve kernels that
``torch.linalg.solve_triangular`` launches (cuBLAS's ``trsv`` and ``trsm``
families, by name) as a share of the traced stretch, in percent.  None
where the stretch holds no such kernel."""

TRISOLVE_KERNELS = ("trsv", "trsm")


def is_trisolve_kernel(name):
    lower = name.lower()
    return any(k in lower for k in TRISOLVE_KERNELS)


def read(ctx):
    s = ctx.stretch
    if s is None or s.trace.window_s <= 0:
        return None
    kernel_ns = sum(ns for name, ns in s.trace.kernels if is_trisolve_kernel(name))
    if kernel_ns == 0:
        return None
    return 100.0 * kernel_ns * 1e-9 / s.trace.window_s
