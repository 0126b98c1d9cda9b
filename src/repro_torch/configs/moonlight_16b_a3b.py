"""moonlight-16b-a3b [moe] (hf:moonshotai/Moonlight-16B-A3B, model_type
deepseek_v3).

27 layers, d_model=2048, 16 heads of DeepSeek-V2 latent attention with no
q-LoRA (kv_lora_rank 512, qk_nope 128, qk_rope 64, v 128); layer 0 a dense
SwiGLU of 11264, layers 1-26 an MoE of 64 routed experts of 1408, top 6,
sigmoid scores with a selection bias (noaux_tc, n_group = topk_group = 1),
the chosen weights normalised and scaled by 2.446, plus 2 shared experts
(one SwiGLU of 2816); no pair dropped.  Vocab 163840, untied; rope_theta
50000; RMSNorm eps 1e-5.  A port-only config (``base.PORT_NAMES``).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonlight_16b_a3b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, kv_heads=16, d_ff=1408,
    vocab=163840, n_experts=64, moe_top_k=6, rope_theta=50000.0,
    norm_eps=1e-5, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    first_dense=1, dense_d_ff=11264, n_shared_experts=2, router="sigmoid",
    routed_scale=2.446,
    source="hf:moonshotai/Moonlight-16B-A3B (hf)")
