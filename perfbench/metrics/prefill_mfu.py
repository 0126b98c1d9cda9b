"""The whole prefill step's share of the card's bf16 peak over the traced
batches, in %: the operations the prefills need (``harness.peaks.
prefill_flops``: the blocks' products, causal attention, the head on the
last position; counted the same whatever implements them) over the
wall of a cycle of the same lengths run without the profiler
(``ctx.untraced_s``) times 989 TFLOP/s (the data sheet's dense bf16 rate
at 700 W).  Moves ``prefill_tok_s``."""

from perfbench.harness.peaks import H100_BF16_OPS_PER_S


def read(ctx):
    flops, wall = ctx.window.get("flops", 0.0), ctx.untraced_s
    if not flops or wall <= 0:
        return None
    return 100.0 * flops / (wall * H100_BF16_OPS_PER_S)
