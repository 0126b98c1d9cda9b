"""LM substrate models of the port (port of ``repro.models``): the dense
decoder-only LM and the registry."""
from . import lm
from .registry import get_model

__all__ = ["lm", "get_model"]
