"""The share of the traced batches' ``attend`` calls that asked for the
port's kernels (``impl="kernel"``) and took a dense route instead
(``attend.kernel_fallback`` over it plus ``attend.flash_attention`` and
``attend.flash_decode``, the program's counters while tracing was on).
In %; a prefill that reaches ``flash_attention`` moves ``prefill_tok_s``."""

from perfbench.harness.program_spans import obs


def read(ctx):
    mod = obs()
    if mod is None:
        return None
    c = mod.counters(traced=True)
    fallback = c.get("attend.kernel_fallback", 0)
    asked = (fallback + c.get("attend.flash_attention", 0)
             + c.get("attend.flash_decode", 0))
    if not asked:
        return None
    return 100.0 * fallback / asked
