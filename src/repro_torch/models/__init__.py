"""LM substrate models of the port (port of ``repro.models``): the
decoder-only LM (dense, MoE, VLM backbone), the RWKV6 LM, the Hymba hybrid,
the Whisper-style encoder-decoder and the registry."""
from . import encdec, hymba, lm, rwkv_lm
from .registry import (decode_cache_len, decode_state_specs, get_model,
                       input_specs)

__all__ = ["lm", "rwkv_lm", "hymba", "encdec", "get_model", "input_specs",
           "decode_state_specs", "decode_cache_len"]
