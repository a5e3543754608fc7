"""ldlt_roofline (kernels: linalg/ldlt_kernels.py -> csrc/ldlt.cu): the
least time of the factors launched in the traced stretch over the device
time of ldlt.cu's kernels, in percent.

The factors launched are the change of ``ldlt_kernels.LAUNCHES`` (counted
on the device inside the graphs); each counts ``roofline.bound`` of the
unpadded KKT matrix, n + m, times the lanes it factors (``rl_batched``
factors the whole stack at once), so the same work counts the same
whichever kernel does it."""

from harness.roofline import bound, is_ldlt_kernel


def read(ctx):
    s = ctx.stretch
    if s is None:
        return None
    kernel_ns = sum(ns for name, ns in s.trace.kernels if is_ldlt_kernel(name))
    if kernel_ns == 0:
        return None
    size = ctx.n + ctx.m
    least = 0.0
    for key, launches in s.launches.items():
        shape = (ctx.lanes, size, size) if key == "rl_batched" else (size, size)
        least += launches * bound(shape)[0]
    return 100.0 * least / (kernel_ns * 1e-9)
