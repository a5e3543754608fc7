"""solves_per_s: Optimal solves (lanes) of all calls of the window over the
time from the window's start to the end of its last call (host clock)."""


def read(ctx):
    return ctx.solves / ctx.window_s
