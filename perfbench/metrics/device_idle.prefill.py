"""The share of the traced batches' wall in which no operation ran on the
device, in %: 1 - the device's busy time in the profiled cycle over the
wall of a cycle of the same lengths run without the profiler
(``ctx.untraced_s``).  Moves ``prefill_tok_s``."""


def read(ctx):
    t = ctx.trace
    if ctx.untraced_s <= 0 or not t.launches:
        return None
    return 100.0 * (1.0 - t.busy_s / ctx.untraced_s)
