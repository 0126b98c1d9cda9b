"""Latent attention's share of the device's busy time, in %: the device
operations launched inside the ``nn/mla`` span (the port's
``MLA.forward`` less the products and norms it calls, which have spans of
their own: the rotary embedding, the latent cache writes, the keys'
assembly and the attention itself, whichever route ``attend`` takes).
Moves ``prefill_tok_s``."""


def read(ctx):
    t = ctx.trace
    s = t.layer_s.get("nn/mla", 0.0)
    if s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * s / t.busy_s
