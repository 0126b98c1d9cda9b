"""Greedy serving of an LM: batched prefill, then one-token decode steps
(port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch <id> [--full] [--device cpu]``
serves a reduced config (the full one with ``--full``) on the card, or on
the CPU when asked, and prints the times and the first sequence.

The inputs come from ``np.random.default_rng(seed)`` in the reference's
order, the weights from a ``torch.Generator`` seeded with ``seed``;
parameters and caches are f32.  Per family, as in the reference:

- token LMs (dense, MoE, RWKV, hybrid): a prompt of ``prompt_len`` tokens,
  a cache of ``prompt_len + gen_len + 8`` positions;
- ``embed_inputs`` LMs (the VLM backbone): ``prompt_len`` standard-normal
  embeddings, and each decode step feeds a zero embedding;
- encoder-decoder: ``prompt_len`` standard-normal frames for the encoder
  and a decoder prompt of ``max(prompt_len // 8, 8)`` tokens, a decoder
  cache of that length ``+ gen_len + 8``.

The generated tokens stay on the device until the loop ends, so a step
makes no host sync; the times are host clocks around work that ends in a
synchronise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import ArchConfig, get_config
from ..models import encdec, registry

__all__ = ["serve_greedy", "replay_batch", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _prompt(cfg, rng, batch: int, prompt_len: int, gen_len: int):
    """(prefill batch as numpy arrays, cache length)."""
    if cfg.family == "encdec":
        sd = max(prompt_len // encdec.DEC_FRAC, 8)
        embeds = rng.standard_normal((batch, prompt_len, cfg.d_model))
        toks = rng.integers(0, cfg.vocab, (batch, sd))
        return ({"embeds": embeds.astype(np.float32), "tokens": toks},
                sd + gen_len + 8)
    if cfg.embed_inputs:
        embeds = rng.standard_normal((batch, prompt_len, cfg.d_model))
        return ({"embeds": embeds.astype(np.float32)},
                prompt_len + gen_len + 8)
    return ({"tokens": rng.integers(0, cfg.vocab, (batch, prompt_len))},
            prompt_len + gen_len + 8)


def serve_greedy(arch, *, batch: int = 4, prompt_len: int = 32,
                 gen_len: int = 16, reduced: bool = True, seed: int = 0,
                 impl: str = "kernel", device=None,
                 keep_logits: bool = False) -> dict:
    """Prefill a random prompt, then ``gen_len - 1`` greedy argmax decode
    steps.  ``arch`` is an arch name (its reduced config unless
    ``reduced=False``) or an ``ArchConfig``, served as given (a config cut
    in depth, for one).

    Returns ``tokens`` [batch, gen_len] (numpy), ``inputs`` (the prefill
    batch, numpy), ``prompt`` (its ``"tokens"``, or its ``"embeds"`` for
    an ``embed_inputs`` LM), ``t_prefill_s``, ``t_decode_s`` and
    ``tok_per_s`` (decode tokens per second); with ``keep_logits``, also
    ``logits`` [batch, gen_len, vocab_padded] on the device: row t is the
    distribution token t was drawn from."""
    dev = resolve_device(device)
    cfg = (arch if isinstance(arch, ArchConfig)
           else get_config(arch, reduced=reduced))
    model_mod = registry.get_model(cfg)
    model = model_mod.init(cfg, seed=seed, dtype=torch.float32, device=dev)
    inputs, max_len = _prompt(cfg, np.random.default_rng(seed), batch,
                              prompt_len, gen_len)
    pf = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
    step_embeds = cfg.embed_inputs and cfg.family != "encdec"
    zero = torch.zeros((batch, 1, cfg.d_model), device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = model_mod.prefill(model, pf, max_len, impl=impl,
                                      cache_dtype=torch.float32)
    tok = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    toks, kept = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        step = {"embeds": zero} if step_embeds else {"tokens": tok}
        logits, state = model_mod.decode_step(model, state, step, impl=impl)
        tok = logits[:, -1].argmax(-1)[:, None]
        toks.append(tok)
        if keep_logits:
            kept.append(logits[:, -1])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = {"tokens": torch.cat(toks, dim=1).cpu().numpy(), "inputs": inputs,
           "prompt": inputs.get("tokens", inputs.get("embeds")),
           "t_prefill_s": t_prefill, "t_decode_s": t_decode,
           "tok_per_s": batch * (gen_len - 1) / max(t_decode, 1e-9)}
    if keep_logits:
        out["logits"] = torch.stack(kept, dim=1)
    return out


def replay_batch(cfg, served: dict) -> tuple[dict, int]:
    """The teacher-forced batch (numpy) whose ``forward`` reproduces a
    ``serve_greedy`` run's logits, and the position of its first served
    row: the prompt followed by the tokens fed back (zero embeddings for an
    ``embed_inputs`` LM; the encoder frames unchanged for encdec).  For a
    MoE config the forward routes the whole replay as one group, so it
    keeps and drops other tokens than the prefill's and the one-token
    decode groups do once an expert's capacity is reached (capacity is per
    group): there only a replay of the prompt alone reproduces the
    prefill's row."""
    inputs, gen = served["inputs"], served["tokens"][:, :-1]
    if cfg.embed_inputs and cfg.family != "encdec":
        e = inputs["embeds"]
        pad = np.zeros((e.shape[0], gen.shape[1], e.shape[2]), e.dtype)
        return {"embeds": np.concatenate([e, pad], 1)}, e.shape[1] - 1
    batch = dict(inputs, tokens=np.concatenate([inputs["tokens"], gen], 1))
    return batch, inputs["tokens"].shape[1] - 1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Greedy serving of an LM arch "
                                 "(reduced unless --full).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="kernel", choices=("kernel", "dense"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = serve_greedy(args.arch, batch=args.batch,
                       prompt_len=args.prompt_len, gen_len=args.gen,
                       reduced=not args.full, seed=args.seed, impl=args.impl,
                       device=args.device)
    print(f"prefill {out['t_prefill_s']:.2f}s decode {out['t_decode_s']:.2f}s"
          f" -> {out['tok_per_s']:.1f} tok/s")
    print("first sequence:", out["tokens"][0][:16])


if __name__ == "__main__":
    main()
