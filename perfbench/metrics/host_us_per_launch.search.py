"""Host microseconds per device operation over the traced rounds: the wall
of the rounds run without the profiler (``ctx.untraced_s``) over the
operations (kernels, copies, fills) that the profiled pass of the same
rounds launched.  The mapper front door is launch-bound where this sets
the pace; moves ``cond_s``."""


def read(ctx):
    t = ctx.trace
    if not t.launches or ctx.untraced_s <= 0:
        return None
    return ctx.untraced_s * 1e6 / t.launches
