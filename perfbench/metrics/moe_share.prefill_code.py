"""The MoE's routing, sort, dispatch and combine as a share of the
device's busy time, in %: the device operations launched inside the
``nn/moe`` span (the port's ``moe_dropless`` less its expert products,
which run in ``nn/moe.experts``).  Moves ``prefill_tok_s``."""


def read(ctx):
    t = ctx.trace
    s = t.layer_s.get("nn/moe", 0.0)
    if s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * s / t.busy_s
