"""LM substrate models of the port (port of ``repro.models``): the dense
decoder-only LM, the RWKV6 LM and the registry."""
from . import lm, rwkv_lm
from .registry import get_model

__all__ = ["lm", "rwkv_lm", "get_model"]
