"""The share of the device's busy time in attention, in %: the device
operations launched inside the ``nn/attention`` span (the port's
``MHA.forward`` less the products and norms it calls, which have spans of
their own: the rotary embedding, the cache writes and the attention
itself, whichever route ``attend`` takes, the port's own kernels
included).  Moves ``prefill_tok_s``."""


def read(ctx):
    t = ctx.trace
    s = t.layer_s.get("nn/attention", 0.0)
    if s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * s / t.busy_s
