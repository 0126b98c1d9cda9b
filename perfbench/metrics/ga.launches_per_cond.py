"""Device operations (kernels, copies, fills) launched per condition
answered in the traced rounds.  The GA's launches per round do not grow
with the conditions, so this is a count that repeats exactly for a given
round size; moves ``cond_s``."""


def read(ctx):
    n = ctx.window.get("conditions", 0)
    if not n or not ctx.trace.launches:
        return None
    return ctx.trace.launches / n
