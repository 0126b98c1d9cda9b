"""Driver of LM prefill for a DeepSeek-V3 block (Moonlight-16B-A3B): the
``lm_prefill`` loop -- one client, closed loop, a batch of prompts of one
length at a time through ``repro_torch.models.lm.prefill`` -- over this
configuration's weights, with a bf16 latent cache of the prompt's length
plus ``cache_extra``, checked against ``reference/deepseek_v3.py``.

The mix's keys are ``lm_prefill``'s (``batch``, ``length``, ``strata``,
``cache_extra``, ``check_per_stratum``).  Set-up grows the allocator to
its peak with the whole model at the longest length, then loads every
length's kernels through a two-layer model over the first two layers'
weights (the dense layer and the first MoE layer).  A window reports the
operations of its prefills (``harness.mla_moe_counts.prefill_flops``).
``SPANS`` wraps the program's latent attention (``nn/mla``), the MoE's
routing, sort, dispatch and combine (``nn/moe``) and its expert products
(``nn/moe.experts``), besides the products, norms and dense MLP.

The weights are drawn from the seed on the device in bf16 (the selection
bias in f32), a few large calls, and handed to the port's model as they
are (``load_state_dict(assign=True)``) and to the reference.

What ``correct`` compares, for the sampled batches, as ``lm_prefill``:
the last position's logits against the reference's f32 forward, as the
largest gap over the largest reference logit (``logit_err``), and how far
the served token's reference logit lies below the reference's best
(``served_gap``).  With random weights one routing choice decided the
other way at a near-tie (the bf16 program's rounding against the f32
reference) sends the two forwards apart in the layers after it, so the
reference follows the routing of what it checks (the program's, replayed
on the batch after the window and read through the program's routing
record, ``repro_torch.nn.moe.recording``), and ``route_gap`` holds each
followed choice to the reference's own selection scores: how far below
its own k-th score a followed choice lies, in score units.
``router_gap`` holds the program's router alone: how far below the k-th
selection score that the reference's f32 router gives on the program's
own MoE inputs (recorded with the choices) a choice lies.
``replay_diff``, the largest gap between the replay's logits and the
served ones, is held to 0, so that the routing followed is the routing
served.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from perfbench.drivers import lm_prefill
from perfbench.harness import traffic
from perfbench.harness.mla_moe_counts import prefill_flops
from perfbench.reference import deepseek_v3 as ref

# The numbers compared and their limits, set from perfbench/calibrate.py
# at the cell's size on one H100 (PERF.md §2): 12 program seeds and 3 of
# the FP8 control, then 36 more runs of the cell.  logit_err: program
# 0.032-0.040, control 0.280-0.318.  served_gap: program 0-0.123, control
# 0.378-0.826.  route_gap: program 0.026-0.036 (1.7% of the 10.9M choices
# followed lie outside the reference's own top 6, every one near a tie),
# control 0.270-0.306; the faults "selection bias ignored" and "latent
# RMSNorm skipped" read 0.116 and 0.086 at the cell's size, and route_gap
# alone fails them.  router_gap: program 0 (9 runs, the same f32 product
# on the same inputs), control 0.042-0.048, the fault "router in bf16"
# 0.0014 at the cell's size (route_gap passes it at 0.026).  replay_diff:
# 0 in all 57 runs (the replay's logits equal the served ones bit for
# bit), and 0 is its limit.
LIMITS = {"logit_err": 0.08, "served_gap": 0.2, "route_gap": 0.06,
          "router_gap": 1e-4, "replay_diff": 0.0}
# Layer label -> the program function whose launches it is charged with.
SPANS = {"nn/linear": "repro_torch.nn.linear:Dense.forward",
         "nn/norms": "repro_torch.nn.norms:RMSNorm.forward",
         "nn/mlp": "repro_torch.nn.transformer:MLP.forward",
         "nn/mla": "repro_torch.nn.mla:MLA.forward",
         "nn/moe": "repro_torch.nn.moe:moe_dropless",
         "nn/moe.experts": "repro_torch.nn.moe:_grouped_experts"}
CONTROL = ref.FP8
_ELEMENTS_A_DRAW = 1 << 31      # a larger leaf is drawn a layer at a time


def shapes(cfg: dict, vocab_rows: int) -> dict:
    """Every weight's shape (``reference/deepseek_v3.py``'s layout)."""
    d, L, H = (cfg["hidden_size"], cfg["num_hidden_layers"],
               cfg["num_attention_heads"])
    r, nope, rope, v = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                        cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    Ld = cfg["first_k_dense_replace"]
    Lm, E = L - Ld, cfg["n_routed_experts"]
    F, f = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * f
    return {"q": (L, d, H * (nope + rope)), "kva": (L, d, r + rope),
            "kvb": (L, r, H * (nope + v)), "o": (L, H * v, d),
            "dense_gate": (Ld, d, F), "dense_up": (Ld, d, F),
            "dense_down": (Ld, F, d), "router": (Lm, d, E),
            "gate": (Lm, E, d, f), "up": (Lm, E, d, f),
            "down": (Lm, E, f, d), "shared_gate": (Lm, d, fs),
            "shared_up": (Lm, d, fs), "shared_down": (Lm, fs, d),
            "embed": (vocab_rows, d), "head": (d, vocab_rows)}


def make_weights(cfg: dict, vocab_rows: int, seed: int, device) -> dict:
    """Seeded weights on ``device``: bf16 N(0, 1/d_in) products, N(0,
    0.02^2) embeddings and unit norm gains, as ``lm_prefill``'s; the
    selection bias f32 N(0, ``init.bias_std``^2).  ``vocab_rows`` is the
    program's padded vocabulary."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    W = {}
    for name, shape in shapes(cfg, vocab_rows).items():
        t = torch.empty(shape, device=device, dtype=torch.bfloat16)
        std = 0.02 if name == "embed" else shape[-2] ** -0.5
        for part in (t if t.numel() > _ELEMENTS_A_DRAW else [t]):
            part.normal_(0.0, std, generator=gen)
        W[name] = t
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    ones = dict(ln1=(L, d), ln2=(L, d), kvn=(L, cfg["kv_lora_rank"]),
                ln_f=(d,))
    for name, shape in ones.items():
        W[name] = torch.ones(shape, device=device, dtype=torch.bfloat16)
    Lm = L - cfg["first_k_dense_replace"]
    W["bias"] = torch.randn((Lm, cfg["n_routed_experts"]), generator=gen,
                            device=device, dtype=torch.float32) \
        * float(cfg["init"]["bias_std"])
    return W


def state_dict(W: dict, L: int, first_dense: int) -> dict:
    """The port's parameter names (``repro_torch.models.lm.LM`` with
    ``MoEBlock``s of latent attention) for the first ``L`` layers, over
    views of ``W`` (the routers as f32 copies)."""
    sd = {"embed.emb": W["embed"], "ln_f.g": W["ln_f"], "head.w": W["head"]}
    for i in range(L):
        b = f"blocks.{i}."
        sd[b + "ln1.g"], sd[b + "ln2.g"] = W["ln1"][i], W["ln2"][i]
        sd[b + "attn.kvn.g"] = W["kvn"][i]
        for n in ("q", "kva", "kvb", "o"):
            sd[b + f"attn.{n}.w"] = W[n][i]
        if i < first_dense:
            for n in ("gate", "up", "down"):
                sd[b + f"mlp.{n}.w"] = W["dense_" + n][i]
            continue
        j = i - first_dense
        # the port keeps its router in f32 (``nn.moe.MoE``)
        sd[b + "moe.router.w"] = W["router"][j].float()
        sd[b + "moe.bias"] = W["bias"][j]
        for n in ("gate", "up", "down", "shared_gate", "shared_up",
                  "shared_down"):
            sd[b + f"moe.{n}"] = W[n][j]
    return sd


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of the configuration file; refuses what
    the port does not run (q-LoRA, expert groups, another router)."""
    from repro_torch.configs import ArchConfig
    if (cfg["q_lora_rank"] is not None or cfg["n_group"] != 1
            or cfg["topk_group"] != 1 or cfg["topk_method"] != "noaux_tc"
            or cfg["scoring_func"] != "sigmoid" or not cfg["norm_topk_prob"]
            or cfg["moe_layer_freq"] != 1):
        raise ValueError(f"{cfg['name']}: the port runs DeepSeek-V3 blocks "
                         "with no q-LoRA, no expert groups and the "
                         "normalised sigmoid router on every layer past "
                         "the dense ones")
    return ArchConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab=cfg["vocab_size"],
        n_experts=cfg["n_routed_experts"],
        moe_top_k=cfg["num_experts_per_tok"],
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=cfg["tie_word_embeddings"], source=cfg["source"],
        norm_eps=float(cfg["rms_norm_eps"]),
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        first_dense=cfg["first_k_dense_replace"],
        dense_d_ff=cfg["intermediate_size"],
        n_shared_experts=cfg["n_shared_experts"], router="sigmoid",
        routed_scale=float(cfg["routed_scaling_factor"]))


class Run(lm_prefill.Run):
    """One run of an ``lm_prefill_mla`` cell: ``lm_prefill.Run`` with this
    configuration's model, weights, warm-up, operation count and
    reference."""

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
        self.model = self._model(arch)
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

    def _model(self, arch):
        """The port's model over views of ``W``."""
        with torch.device("meta"):
            model = self.lm.LM(arch, dtype=torch.bfloat16)
        model.load_state_dict(state_dict(self.W, arch.n_layers,
                                         arch.first_dense), assign=True)
        return model.eval()

    def _warm_shapes(self, arch, lengths, gen) -> None:
        """Each length once through a model of the first two layers (the
        dense layer and the first MoE layer): every kind of layer, the
        head and the argmax at each of the mix's shapes."""
        whole = self.model
        self.model = self._model(dataclasses.replace(
            arch, n_layers=arch.first_dense + 1))
        try:
            for S in lengths:
                self._prefill(S, gen)
        finally:
            self.model = whole

    def _summary(self, wall, done=None) -> dict:
        """``lm_prefill.Run._summary`` with this block's operation count:
        the parent's counts with ``peaks.prefill_flops``, which reads a
        ``head_dim`` that latent attention does not have."""
        done = self.done if done is None else done
        tokens = self.B * sum(r["S"] for r in done)
        ttft = np.repeat([r["ttft_s"] for r in done], self.B)
        out = {"attempted": self.B * len(done), "failed": 0,
               "tokens": tokens,
               "flops": sum(prefill_flops(self.config, self.B, r["S"])
                            for r in done),
               "batches": [(self.B, r["S"]) for r in done]}
        if wall is not None:
            out["e2e"] = {"prefill_tok_s": tokens / wall,
                          "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3}
        return out

    def release(self) -> None:
        """Frees what the window left on the device; keeps the model,
        whose parameters are views of the weights that the reference
        reads anyway, for :meth:`check`'s replay of the routing."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def routing(self, tokens: torch.Tensor):
        """The program's routing of a served batch: its prefill run again
        on ``tokens`` inside the program's routing record, each MoE layer's
        ``(input [B, S, d], chosen experts [B, S, k])``; and the replay's
        last logits over the vocabulary."""
        from repro_torch.nn import moe
        S = tokens.shape[1]
        with moe.recording() as seen:
            logits, _ = self.lm.prefill(
                self.model, {"tokens": tokens},
                S + int(self.mix["cache_extra"]), impl="kernel",
                cache_dtype=torch.bfloat16)
        return seen, logits[:, 0, :self.config["vocab_size"]]

    def check(self, prec=None) -> dict:
        """The numbers compared, each with its limit: ``lm_prefill``'s
        against the reference, which follows the routing of what it checks
        (the program's, replayed by :meth:`routing`; or the control's own),
        and ``route_gap``, how far below the reference's own k-th selection
        score a followed choice lies; ``router_gap``, how far below the
        k-th score of the reference's f32 router on the same inputs a
        choice lies (the program's, or the control's own); and
        ``replay_diff``, how far the replay's logits lie from the served
        ones (0 for the control, which replays nothing).  Prints how many
        followed choices lie outside the reference's own top k."""
        err = gap = route = router = replay = 0.0
        flips = choices = same = 0
        for i in self.sample():
            r = self.done[i]
            if prec is None:
                got, served = r["logits"].float(), r["served"]
                seen, again = self.routing(r["tokens"])
                replay = max(replay, float(
                    (again.float() - got).abs().max()))
                same += int(torch.equal(again, r["logits"]))
                for j, (x, idx) in enumerate(seen):
                    router = max(router, ref.router_gap(
                        x.reshape(-1, x.shape[-1]), self.W["router"][j],
                        self.W["bias"][j], idx.reshape(-1, idx.shape[-1])))
                follow = [idx for _, idx in seen]
                del seen, again
            else:
                mine: dict = {}
                got = ref.last_logits(self.W, r["tokens"], self.config,
                                      prec=prec, stats=mine)
                served, follow = got.argmax(-1).tolist(), mine["chosen"]
                router = max(router, mine["router_gap"])
            st: dict = {}
            want = ref.last_logits(self.W, r["tokens"], self.config,
                                   follow=follow, stats=st)
            top = want.abs().amax(-1)
            err = max(err, float(((got - want).abs().amax(-1) / top).max()))
            best = want.amax(-1)
            at = want.gather(-1, torch.as_tensor(served, device=want.device)
                             [:, None])[:, 0]
            gap = max(gap, float((best - at).max()))
            route = max(route, st["route_gap"])
            flips, choices = flips + st["flips"], choices + st["choices"]
        replays = "" if prec is not None else (
            f"; replays equal to the served logits: {same} of "
            f"{len(self.sample())}")
        print(f"perfbench: routing choices outside the reference's own top "
              f"k: {flips} of {choices}{replays}", file=sys.stderr, flush=True)
        got = {"logit_err": err, "served_gap": gap, "route_gap": route,
               "router_gap": router, "replay_diff": replay}
        return {k: (v, LIMITS[k]) for k, v in got.items()}
