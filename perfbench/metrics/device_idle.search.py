"""The share of the traced rounds' wall in which no operation ran on the
device, in %: 1 - the device's busy time in the profiled pass over the
wall of the same rounds run without the profiler (``ctx.untraced_s``; the
profiler slows the host, so its own wall reads idle too high).  Moves
``cond_s``."""


def read(ctx):
    t = ctx.trace
    if ctx.untraced_s <= 0 or not t.launches:
        return None
    return 100.0 * (1.0 - t.busy_s / ctx.untraced_s)
