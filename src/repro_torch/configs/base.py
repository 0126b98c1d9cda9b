"""ArchConfig schema, the shape grid, and the (arch x shape) cell policy.

A copy of ``repro.configs.base`` (pure Python): the same configs, the same
``reduced()`` and the same ``source`` strings.  The port's ``ArchConfig``
adds fields the reference lacks, each defaulting to what the reference
does (``norm_eps``, latent attention, leading dense layers, shared
experts, the sigmoid router, the dropless expert path); they serve the
port-only configs of :data:`PORT_NAMES`, which ``get_config`` resolves
beside the reference's grid (:data:`ARCH_NAMES`, ``cells()``) without
joining it.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace

__all__ = ["ArchConfig", "Shape", "SHAPES", "ARCH_NAMES", "PORT_NAMES",
           "get_config", "cells"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None    # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    mlp_kind: str = "swiglu"
    norm: str = "rms"
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # gemma3-style local/global interleave: window per layer position in the
    # repeating pattern; <=0 means full attention.
    window_pattern: tuple[int, ...] = (-1,)
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    # encoder-decoder (whisper): n_layers = decoder layers
    encoder_layers: int = 0
    # VLM M-RoPE half-dim sections (t, h, w); None = standard RoPE
    mrope_sections: tuple[int, int, int] | None = None
    # modality frontend stub: model consumes precomputed embeddings
    embed_inputs: bool = False
    source: str = ""
    # -- port-only fields (module docstring) --
    norm_eps: float | None = None  # None: the norm's default (RMS 1e-6)
    # latent attention (DeepSeek-V2 MLA, no q-LoRA); 0 = GQA attention
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # the first ``first_dense`` layers of an MoE stack carry a dense SwiGLU
    # of width ``dense_d_ff``; ``d_ff`` stays the expert width
    first_dense: int = 0
    dense_d_ff: int = 0
    n_shared_experts: int = 0      # one shared SwiGLU of n x d_ff
    # "softmax" (the capacity path) or "sigmoid" (a selection bias, dropless)
    router: str = "softmax"
    routed_scale: float = 1.0

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def rope_dim(self) -> int:
        """Head dims the rotary embedding turns: MLA's decoupled key's,
        else the whole head."""
        return self.qk_rope_head_dim if self.mla else self.hd

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256 for clean TP sharding (Megatron practice)."""
        return _round_up(self.vocab, 256)

    def window_for_layer(self, i: int) -> int:
        return self.window_pattern[i % len(self.window_pattern)]

    def windows(self) -> list[int]:
        return [self.window_for_layer(i) for i in range(self.n_layers)]

    @property
    def is_sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN §5): attention-free, hybrid, or
        sliding-window-dominant stacks."""
        if self.family in ("ssm", "hybrid"):
            return True
        wins = self.windows()
        local = sum(1 for w in wins if w > 0)
        return local >= 0.8 * len(wins)

    def reduced(self) -> "ArchConfig":
        """Same-family smoke-test reduction (runs a CPU train step)."""
        return replace(
            self, n_layers=min(self.n_layers, 2 if self.family != "encdec" else 2),
            d_model=64, n_heads=4, kv_heads=max(1, min(self.kv_heads, 2)),
            head_dim=16, d_ff=128, vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            encoder_layers=min(self.encoder_layers, 2),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            window_pattern=tuple(min(w, 32) if w > 0 else w
                                 for w in self.window_pattern),
            mrope_sections=(4, 2, 2) if self.mrope_sections else None,
            kv_lora_rank=min(self.kv_lora_rank, 32),
            qk_nope_head_dim=min(self.qk_nope_head_dim, 16),
            qk_rope_head_dim=min(self.qk_rope_head_dim, 8),
            v_head_dim=min(self.v_head_dim, 16),
            dense_d_ff=min(self.dense_d_ff, 128))

    def param_count(self) -> float:
        """Analytic parameter count (embeddings + blocks + head)."""
        if self.mla:
            return self._mla_param_count()
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.family == "ssm":                     # rwkv6 block
            mix = 4 * d * d + d * self.d_ff + self.d_ff * d
            blocks = self.n_layers * mix
        else:
            if self.n_experts:
                ffn = self.n_experts * 3 * d * self.d_ff
            elif self.mlp_kind == "swiglu":
                ffn = 3 * d * self.d_ff
            else:
                ffn = 2 * d * self.d_ff
            blocks = self.n_layers * (attn + ffn)
            if self.family == "hybrid":
                blocks += self.n_layers * (2 * d * d + d * self.ssm_state * 2)
            if self.family == "encdec":
                blocks += self.encoder_layers * (attn + ffn) \
                    + self.n_layers * attn   # cross-attn
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        return float(blocks + emb)

    def _mla_param_count(self) -> float:
        """:meth:`param_count` of an MLA stack: the latent attention, the
        leading dense layers, and the MoE layers' routed experts, shared
        expert and router (norm gains and the selection bias left out)."""
        d, H, r = self.d_model, self.n_heads, self.kv_lora_rank
        nope, rope, v = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                         self.v_head_dim)
        attn = d * H * (nope + rope) + d * (r + rope) + r * H * (nope + v) \
            + H * v * d
        moe = (self.n_experts + self.n_shared_experts) * 3 * d * self.d_ff \
            + d * self.n_experts
        blocks = self.n_layers * attn + self.first_dense * 3 * d \
            * self.dense_d_ff + (self.n_layers - self.first_dense) * moe
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        return float(blocks + emb)

    def active_param_count(self) -> float:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_layers = self.n_layers - self.first_dense
        all_exp = moe_layers * self.n_experts * 3 * d * self.d_ff
        act_exp = moe_layers * self.moe_top_k * 3 * d * self.d_ff
        return float(full - all_exp + act_exp)


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

ARCH_NAMES = [
    "whisper_base", "gemma3_1b", "qwen15_4b", "minitron_4b", "qwen3_8b",
    "grok1_314b", "qwen3_moe_235b", "rwkv6_3b", "qwen2_vl_72b", "hymba_15b",
]
# configs of the port alone: get_config resolves them, cells() leaves them out
PORT_NAMES = ["moonlight_16b_a3b"]

_ALIASES = {n.replace("_", "-"): n for n in ARCH_NAMES + PORT_NAMES}


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    key = _ALIASES.get(name, name)
    if key not in ARCH_NAMES + PORT_NAMES:
        raise KeyError(f"unknown arch {name!r}; have "
                       f"{ARCH_NAMES + PORT_NAMES}")
    cfg = importlib.import_module(f"{__package__}.{key}").CONFIG
    return cfg.reduced() if reduced else cfg


def cells(include_skipped: bool = False):
    """Yield (arch_name, shape_name, runnable, why) for all 40 cells."""
    for a in ARCH_NAMES:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = True, ""
            if s.name == "long_500k" and not cfg.is_sub_quadratic:
                ok, why = False, "pure full attention at 512k (DESIGN §5 skip)"
            if ok or include_skipped:
                yield (a, s.name, ok, why)
