"""Greedy serving of an LM: batched prefill, then one-token decode steps
(port of ``repro.launch.serve.serve_greedy``).

The prompt comes from ``np.random.default_rng(seed)``, the weights from a
``torch.Generator`` seeded with ``seed``; parameters and caches are f32
and the cache holds ``prompt_len + gen_len + 8`` positions, as in the
reference.  The generated tokens stay on the device until the loop ends,
so a step makes no host sync; the times are host clocks around work that
ends in a synchronise.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..models import registry

__all__ = ["serve_greedy"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_greedy(arch: str, *, batch: int = 4, prompt_len: int = 32,
                 gen_len: int = 16, reduced: bool = True, seed: int = 0,
                 impl: str = "kernel", device=None,
                 keep_logits: bool = False) -> dict:
    """Prefill a random prompt [batch, prompt_len], then ``gen_len - 1``
    greedy argmax decode steps.

    Returns ``tokens`` [batch, gen_len] (numpy), the ``prompt``,
    ``t_prefill_s``, ``t_decode_s`` and ``tok_per_s`` (decode tokens per
    second); with ``keep_logits``, also ``logits`` [batch, gen_len,
    vocab_padded] on the device: row t is the distribution token t was
    drawn from."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    model_mod = registry.get_model(cfg)
    model = model_mod.init(cfg, seed=seed, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len))
    ids = torch.as_tensor(prompt, device=dev)
    max_len = prompt_len + gen_len + 8

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = model_mod.prefill(model, {"tokens": ids}, max_len,
                                      impl=impl, cache_dtype=torch.float32)
    tok = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    toks, kept = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        logits, state = model_mod.decode_step(model, state, {"tokens": tok},
                                              impl=impl)
        tok = logits[:, -1].argmax(-1)[:, None]
        toks.append(tok)
        if keep_logits:
            kept.append(logits[:, -1])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = {"tokens": torch.cat(toks, dim=1).cpu().numpy(), "prompt": prompt,
           "t_prefill_s": t_prefill, "t_decode_s": t_decode,
           "tok_per_s": batch * (gen_len - 1) / max(t_decode, 1e-9)}
    if keep_logits:
        out["logits"] = torch.stack(kept, dim=1)
    return out
