"""kernels_per_solve (iteration body: newton.py, implicit_func.py, step/,
eval.py, problem.py, linalg/): CUDA kernels in the profiler's trace of the
stretch over the solves (lanes) completed in it."""


def read(ctx):
    s = ctx.stretch
    if s is None or not s.trace.kernels or s.solves == 0:
        return None
    return len(s.trace.kernels) / s.solves
