"""Attention's share of its roofline over the traced batches, in %: the
least time of every layer's causal attention over the batch's prompts
(``harness.peaks.fa_bound_ms`` at bf16, the served type) over the device
time of the ``nn/attention`` span (``attention_share.prefill``'s),
whatever implements it.  Moves ``prefill_tok_s``."""

from perfbench.harness.peaks import fa_bound_ms


def read(ctx):
    s = ctx.trace.layer_s.get("nn/attention", 0.0)
    shapes = ctx.window.get("batches", [])
    if s <= 0 or not shapes:
        return None
    c = ctx.config
    L, Hq, Hkv, hd = (c["num_hidden_layers"], c["num_attention_heads"],
                      c["num_key_value_heads"], c["head_dim"])
    bound_ms = sum(L * fa_bound_ms(B, S, S, Hq, Hkv, hd, True, -1, 2)[0]
                   for B, S in shapes)
    return 100.0 * bound_ms * 1e-3 / s
