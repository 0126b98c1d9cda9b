"""``fusion_eval``'s share of the device's busy time over the traced
rounds, in %; moves ``cond_s``."""

KERNEL = r"fusion_eval_kernel"


def read(ctx):
    s, n = ctx.trace.seconds(KERNEL)
    if not n or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * s / ctx.trace.busy_s
