"""idle_share (device): 1 - the union of kernel, copy and set intervals
over the traced stretch, in percent."""


def read(ctx):
    s = ctx.stretch
    if s is None or not s.trace.kernels or s.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.trace.busy_s / s.trace.window_s)
