"""Driver of LM prefill: a closed loop of one client that sends a batch of
prompts of one length, waits for their first tokens, and sends the next,
through ``repro_torch.models.lm.prefill`` (the time to the first token of
the port's serving path), with a bf16 cache of the prompt's length plus
``cache_extra``.

The mix's keys: ``batch`` (prompts a request batch holds), ``length`` (a
distribution spec of the prompt length, ``harness.traffic``), ``strata``
(the lengths a run cycles through: the same set for every seed, each
cycle in an order drawn from the seed; the window runs whole cycles until
``--seconds`` have passed, so every seed does the same work),
``cache_extra``, ``check_per_stratum`` (how many batches of each length
the reference re-derives after the window, drawn from the seed; the
longest length is one of them).  A traced run times one cycle without the
profiler, then profiles one more.  ``SPANS`` names the program functions
that a traced run wraps in layer spans (``harness.trace.layer_spans``),
under the labels that the per-layer readers read.

The weights are the benchmark's: drawn from the seed on the device in
bf16, a few large calls, handed to the port's model as they are
(``load_state_dict(assign=True)``) and to the reference.

What ``correct`` compares, for the sampled batches: the last position's
logits against the reference's f32 forward (``reference/qwen3.py``), as
the largest gap over the largest reference logit (``logit_err``), and how
far the served token's reference logit lies below the reference's best
(``served_gap``).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from perfbench.harness import traffic
from perfbench.harness.peaks import prefill_flops
from perfbench.reference import qwen3 as ref

# The numbers compared and their limits (PERF.md gives the readings each
# was set from).
LIMITS = {"logit_err": 0.08, "served_gap": 0.2}
# Layer label -> the program function whose launches it is charged with.
SPANS = {"nn/linear": "repro_torch.nn.linear:Dense.forward",
         "nn/attention": "repro_torch.nn.attention:MHA.forward",
         "nn/norms": "repro_torch.nn.norms:RMSNorm.forward",
         "nn/mlp": "repro_torch.nn.transformer:MLP.forward"}


def make_weights(cfg: dict, vocab_rows: int, seed: int, device) -> dict:
    """Seeded bf16 weights on ``device``, one draw per kind of leaf with the
    layers stacked: N(0, 1/d_in) products, N(0, 0.02^2) embeddings, unit
    norm gains.  ``vocab_rows`` is the program's padded vocabulary."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hq = cfg["num_attention_heads"] * cfg["head_dim"]
    hkv = cfg["num_key_value_heads"] * cfg["head_dim"]
    ff, hd = cfg["intermediate_size"], cfg["head_dim"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = {"q": (L, d, hq), "k": (L, d, hkv), "v": (L, d, hkv),
              "o": (L, hq, d), "gate": (L, d, ff), "up": (L, d, ff),
              "down": (L, ff, d), "embed": (vocab_rows, d),
              "head": (d, vocab_rows)}
    W = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
        std = 0.02 if name == "embed" else 1.0 / math.sqrt(shape[-2])
        W[name] = t.mul_(std)
    ones = dict(ln1=(L, d), ln2=(L, d), qn=(L, hd), kn=(L, hd), ln_f=(d,))
    for name, shape in ones.items():
        W[name] = torch.ones(shape, device=device, dtype=torch.bfloat16)
    return W


def state_dict(W: dict, L: int) -> dict:
    """The port's parameter names (``repro_torch.models.lm.LM``) over views
    of ``W``."""
    sd = {"embed.emb": W["embed"], "ln_f.g": W["ln_f"], "head.w": W["head"]}
    for i in range(L):
        b = f"blocks.{i}."
        sd[b + "ln1.g"], sd[b + "ln2.g"] = W["ln1"][i], W["ln2"][i]
        sd[b + "attn.qn.g"], sd[b + "attn.kn.g"] = W["qn"][i], W["kn"][i]
        for n in ("q", "k", "v", "o"):
            sd[b + f"attn.{n}.w"] = W[n][i]
        for n in ("gate", "up", "down"):
            sd[b + f"mlp.{n}.w"] = W[n][i]
    return sd


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of the configuration file."""
    from repro_torch.configs import ArchConfig
    return ArchConfig(
        name=cfg["name"], family="dense", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        qk_norm=True, rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=cfg["tie_word_embeddings"], source=cfg["source"])


class Run:
    """One run of an ``lm_prefill`` cell: ``setup``, ``window``,
    ``release``, ``check``."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.B = int(mix["batch"])
        self.done: list[dict] = []
        self.stages: dict[str, float] = {}

    def setup(self) -> None:
        t = time.perf_counter()
        from repro_torch.models import lm
        self.lm = lm
        self.stages["import_s"] = time.perf_counter() - t
        cfg = self.config
        arch = arch_config(cfg)
        if cfg["torch_dtype"] != "bfloat16" or cfg["cache_dtype"] != "bfloat16":
            raise ValueError("the driver serves bf16 weights and cache")
        t = time.perf_counter()
        self.W = make_weights(cfg, arch.vocab_padded, self.seed, self.device)
        self._sync()
        self.stages["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        with torch.device("meta"):
            model = lm.LM(arch, dtype=torch.bfloat16)
        model.load_state_dict(state_dict(self.W, arch.n_layers), assign=True)
        self.model = model.eval()
        self.stages["model_s"] = time.perf_counter() - t
        strata = traffic.stratified(self.mix["length"],
                                    int(self.mix["strata"]))
        self.lengths = traffic.cycles([int(x) for x in strata],
                                      traffic.rng_for(self.seed, 1))
        self.tok_gen = torch.Generator(device=self.device).manual_seed(
            int(traffic.rng_for(self.seed, 2).integers(0, 2 ** 62)))
        warm = torch.Generator(device=self.device).manual_seed(0)
        t = time.perf_counter()
        self._prefill(int(max(strata)), warm)
        self._warm_shapes(arch, [int(x) for x in strata], warm)
        self._sync()
        self.stages["warm_s"] = time.perf_counter() - t

    def _warm_shapes(self, arch, lengths, gen) -> None:
        """Load every kernel the mix's lengths use before the window: each
        length once through a one-block model over the first block's
        weights, which runs the same products, attention, head and argmax
        at 1/36 of the cost (the whole model at the longest length has
        already grown the allocator to its peak)."""
        one = dataclasses.replace(arch, n_layers=1)
        with torch.device("meta"):
            model = self.lm.LM(one, dtype=torch.bfloat16)
        model.load_state_dict(state_dict(self.W, 1), assign=True)
        whole, self.model = self.model, model.eval()
        try:
            for S in lengths:
                self._prefill(S, gen)
        finally:
            self.model = whole

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, S: int, gen) -> dict:
        """One batch of ``B`` prompts of ``S`` tokens: submitted, prefilled,
        its first tokens read on the host."""
        V = self.config["vocab_size"]
        tokens = torch.randint(0, V, (self.B, S), generator=gen,
                               device=self.device)
        t0 = time.perf_counter()
        logits, state = self.lm.prefill(
            self.model, {"tokens": tokens},
            S + int(self.mix["cache_extra"]), impl="kernel",
            cache_dtype=torch.bfloat16)
        last = logits[:, 0, :V]
        served = last.argmax(-1).tolist()
        ttft = time.perf_counter() - t0
        del state
        return {"S": S, "tokens": tokens, "logits": last, "served": served,
                "ttft_s": ttft}

    def window(self, seconds: float) -> dict:
        """Whole cycles of batches back to back until ``seconds`` have
        passed; the window ends with the last batch's first tokens."""
        t0 = time.perf_counter()
        while True:
            self._cycle()
            wall = time.perf_counter() - t0
            if wall >= seconds:
                break
        return self._summary(wall)

    def _cycle(self) -> None:
        for S in next(self.lengths):
            self.done.append(self._prefill(S, self.tok_gen))

    def traced_window(self) -> dict:
        """One cycle; the caller times one without its profiler, then
        profiles one more."""
        start = len(self.done)
        self._cycle()
        return self._summary(None, self.done[start:])

    def _summary(self, wall, done=None) -> dict:
        done = self.done if done is None else done
        n = self.B * len(done)
        tokens = self.B * sum(r["S"] for r in done)
        ttft = np.repeat([r["ttft_s"] for r in done], self.B)
        flops = sum(prefill_flops(self.config, self.B, r["S"]) for r in done)
        out = {"attempted": n, "failed": 0, "tokens": tokens, "flops": flops,
               "batches": [(self.B, r["S"]) for r in done]}
        if wall is not None:
            out["e2e"] = {"prefill_tok_s": tokens / wall,
                          "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3}
        return out

    def release(self) -> None:
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------
    def sample(self) -> list[int]:
        """The batches the reference re-derives: ``check_per_stratum`` of
        each length served, drawn from the seed."""
        k = int(self.mix["check_per_stratum"])
        by_len: dict[int, list[int]] = {}
        for i in traffic.rng_for(self.seed, 3).permutation(len(self.done)):
            by_len.setdefault(self.done[i]["S"], []).append(int(i))
        return sorted(i for S in sorted(by_len) for i in by_len[S][:k])

    def check(self, prec=None) -> dict:
        """The numbers compared, each with its limit.  With ``prec`` (the
        control), the reference in that precision stands in for the
        program's logits and served tokens."""
        err = gap = 0.0
        for i in self.sample():
            r = self.done[i]
            want = ref.last_logits(self.W, r["tokens"], self.config)
            if prec is None:
                got, served = r["logits"].float(), r["served"]
            else:
                got = ref.last_logits(self.W, r["tokens"], self.config,
                                      prec=prec)
                served = got.argmax(-1).tolist()
            top = want.abs().amax(-1)
            err = max(err, float(((got - want).abs().amax(-1) / top).max()))
            best = want.amax(-1)
            at = want.gather(-1, torch.as_tensor(served, device=want.device)
                             [:, None])[:, 0]
            gap = max(gap, float((best - at).max()))
        got = {"logit_err": err, "served_gap": gap}
        return {k: (v, LIMITS[k]) for k, v in got.items()}


CONTROL = ref.FP8
