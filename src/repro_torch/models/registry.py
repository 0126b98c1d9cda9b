"""Model registry: ArchConfig -> model module (port of the
``get_model`` half of ``repro.models.registry``).

The dense family (``lm``) and the attention-free RWKV6 family
(``ssm``: ``rwkv_lm``) are ported; the others raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

from ..configs import ArchConfig
from . import lm, rwkv_lm

__all__ = ["get_model"]

_PORTED = {"dense": lm, "ssm": rwkv_lm}
_LATER = {"moe": "the MoE slice", "vlm": "the VLM slice",
          "hybrid": "the hybrid (hymba) slice",
          "encdec": "the encoder-decoder (whisper) slice"}


def get_model(cfg: ArchConfig):
    """The module implementing ``cfg``'s family (``MODEL``, ``init``,
    ``forward``, ``prefill``, ``decode_step``, ...)."""
    if cfg.family in _PORTED:
        return _PORTED[cfg.family]
    if cfg.family in _LATER:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family "
                                  f"comes with {_LATER[cfg.family]} of the "
                                  "port")
    raise KeyError(f"unknown model family {cfg.family!r}")
