"""The share of the device's busy time in the blocks' weight products, in
%: the kernels launched inside the ``nn/linear`` span, which the prefill
mixes put around the port's ``Dense.forward`` (q, k, v, o and the MLP's
gate, up and down).  Moves ``prefill_tok_s``."""

LAYERS = ("nn/linear",)


def read(ctx):
    t = ctx.trace
    s = sum(t.layer_s.get(k, 0.0) for k in LAYERS)
    if s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * s / t.busy_s
