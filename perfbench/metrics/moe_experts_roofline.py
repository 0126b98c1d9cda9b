"""The MoE's expert products' share of their roofline over the traced
batches, in %: their least time (``harness.mla_moe_counts.experts_bound``
at bf16: the routed and shared experts' operations over 989 TFLOP/s
against each held expert's weights and the pairs' rows in and out over
3.35 TB/s) over the device time of the ``nn/moe.experts`` span, whatever
implements the products.  Moves ``prefill_tok_s``."""

from perfbench.harness.mla_moe_counts import experts_bound


def read(ctx):
    s = ctx.trace.layer_s.get("nn/moe.experts", 0.0)
    shapes = ctx.window.get("batches", [])
    if s <= 0 or not shapes:
        return None
    bound_ms = sum(experts_bound(ctx.config, B, S)[0] for B, S in shapes)
    return 100.0 * bound_ms * 1e-3 / s
