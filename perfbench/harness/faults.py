"""Faults planted under the timed path, for the tests that show the
comparison fails them and for ``calibrate.py --fault`` (a fault's
readings at a cell's own size).  ``run.py`` never plants one.  Each is a
context manager that patches the program while it is entered."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(owner, attr, new):
    real = getattr(owner, attr)
    setattr(owner, attr, new(real))
    try:
        yield
    finally:
        setattr(owner, attr, real)


# -- the mapper: gsampler_search_grid ------------------------------------

@contextlib.contextmanager
def ga_state_unchanged():
    """Each GA generation returns the population it was given: the next
    population (the ``torch.cat`` of elites and brood) is replaced by the
    one the generation evaluated."""
    from repro_torch.core import cost_model as cm, gsampler as gs
    seen = {}

    def remember(real):
        def call(wls, strategies, *a, **k):
            seen["pop"] = strategies
            return real(wls, strategies, *a, **k)
        return call

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def cat(ts, dim=0):
            pop = seen.get("pop")
            if (dim == 1 and pop is not None
                    and sum(t.shape[1] for t in ts) == pop.shape[1]):
                return pop.clone()
            return torch.cat(ts, dim=dim)

    with _patched(cm, "evaluate_grid", remember), \
            _patched(gs, "torch", lambda real: Torch()):
        yield


@contextlib.contextmanager
def half_conditions():
    """Only the first half of a round's conditions is searched; the rest
    are given its answers."""
    from repro_torch.core import gsampler as gs

    def half(real):
        def call(workloads, hw, batches, budgets, *, packed, **kw):
            h = len(workloads) // 2
            out = real(workloads[:h], hw[:h], batches[:h], budgets[:h],
                       packed={k: v[:h] for k, v in packed.items()}, **kw)
            for f in ("strategies", "latency", "peak_mem", "valid",
                      "speedup"):
                x = getattr(out, f)
                setattr(out, f, np.concatenate([x, x])[:len(workloads)])
            return out
        return call

    with _patched(gs, "gsampler_search_grid", half):
        yield


@contextlib.contextmanager
def answer_altered():
    """The GA's reported latencies are off by one part in a thousand."""
    from repro_torch.core import gsampler as gs

    def altered(real):
        def call(*a, **k):
            out = real(*a, **k)
            out["latency"] = out["latency"] * 1.001
            return out
        return call

    with _patched(gs, "_ga_grid", altered):
        yield


# -- the LM: lm.prefill ----------------------------------------------------

@contextlib.contextmanager
def block_state_unchanged():
    """Every second block returns its input unchanged."""
    from repro_torch.nn import transformer
    calls = {"n": 0}

    def skip(real):
        def call(self, x, **kw):
            calls["n"] += 1
            if calls["n"] % 2 == 0:
                return x, kw.get("cache")
            return real(self, x, **kw)
        return call

    with _patched(transformer.Block, "forward", skip):
        yield


@contextlib.contextmanager
def half_batch():
    """Only the first half of a batch is prefilled; the rest get its
    answers."""
    from repro_torch.models import lm

    def half(real):
        def call(model, batch, max_len, **kw):
            t = batch["tokens"]
            h = max(t.shape[0] // 2, 1)
            logits, state = real(model, {"tokens": t[:h]}, max_len, **kw)
            rep = -(-t.shape[0] // h)
            return logits.repeat(rep, 1, 1)[:t.shape[0]], state
        return call

    with _patched(lm, "prefill", half):
        yield


@contextlib.contextmanager
def token_altered():
    """The logits come out shifted by one token, so the first token served
    is not the argmax."""
    from repro_torch.models import lm

    def shifted(real):
        def call(*a, **k):
            logits, state = real(*a, **k)
            return torch.roll(logits, 1, dims=-1), state
        return call

    with _patched(lm, "prefill", shifted):
        yield


FAULTS = {"ga_state_unchanged": ga_state_unchanged,
          "half_conditions": half_conditions,
          "answer_altered": answer_altered,
          "block_state_unchanged": block_state_unchanged,
          "half_batch": half_batch, "token_altered": token_altered}
