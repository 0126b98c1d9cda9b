"""whisper-base [audio]: enc-dec transformer backbone (arXiv:2212.04356).

6 encoder + 6 decoder layers, d_model=512, 8 heads (kv=8), d_ff=2048,
vocab=51865.  The conv/mel frontend is a STUB: ``input_specs()`` feeds
precomputed frame embeddings of length seq_len; decoder length = seq_len//8.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_base", family="encdec",
    n_layers=6, encoder_layers=6, d_model=512, n_heads=8, kv_heads=8,
    d_ff=2048, vocab=51865, mlp_kind="gelu", norm="layer",
    embed_inputs=True, tie_embeddings=True,
    source="arXiv:2212.04356 (unverified)")
