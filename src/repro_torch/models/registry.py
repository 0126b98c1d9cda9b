"""Model registry: ArchConfig -> model module, and the model inputs' and
decode states' shapes (port of ``repro.models.registry``).

Every family maps to its module: dense, MoE and VLM to ``lm``, ``ssm`` to
``rwkv_lm``, ``hybrid`` to ``hymba`` and ``encdec`` to ``encdec``.  The
reference's ``ShapeDtypeStruct`` stand-ins become tensors on the ``meta``
device, which carry a shape and a dtype and allocate nothing:
:func:`input_specs` gives the inputs of a (config, shape) cell, and
:func:`decode_state_specs` runs the model's own ``init_decode_state`` on
``meta``, so the specs always match the real state (whose write index
``idx`` is a Python int in the port, where the reference's is an int32
array).
"""
from __future__ import annotations

import torch

from ..configs import ArchConfig, Shape
from . import encdec, hymba, lm, rwkv_lm

__all__ = ["get_model", "input_specs", "decode_state_specs",
           "decode_cache_len"]

_FAMILY = {"dense": lm, "moe": lm, "vlm": lm, "ssm": rwkv_lm,
           "hybrid": hymba, "encdec": encdec}
_META = torch.device("meta")


def get_model(cfg: ArchConfig):
    """The module implementing ``cfg``'s family (``MODEL``, ``init``,
    ``forward``, ``loss_fn``, ``prefill``, ``decode_step``, ...)."""
    if cfg.family not in _FAMILY:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return _FAMILY[cfg.family]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def decode_cache_len(cfg: ArchConfig, shape: Shape) -> int:
    """KV/cache length for decode shapes (encdec: the decoder's length)."""
    if cfg.family == "encdec":
        return max(shape.seq_len // encdec.DEC_FRAC, 8)
    return shape.seq_len


def input_specs(cfg: ArchConfig, shape: Shape, *,
                act_dtype=torch.bfloat16) -> dict:
    """Model inputs of the (cfg, shape) cell as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    i32 = torch.int32
    if cfg.family == "encdec":
        sd = max(S // encdec.DEC_FRAC, 8)
        if kind == "train":
            return {"embeds": _spec((B, S, cfg.d_model), act_dtype),
                    "tokens": _spec((B, sd), i32),
                    "labels": _spec((B, sd), i32)}
        if kind == "prefill":
            return {"embeds": _spec((B, S, cfg.d_model), act_dtype),
                    "tokens": _spec((B, sd), i32)}
        return {"tokens": _spec((B, 1), i32)}
    if cfg.embed_inputs:                      # the VLM's stub frontend
        if kind == "train":
            return {"embeds": _spec((B, S, cfg.d_model), act_dtype),
                    "labels": _spec((B, S), i32)}
        if kind == "prefill":
            return {"embeds": _spec((B, S, cfg.d_model), act_dtype)}
        return {"embeds": _spec((B, 1, cfg.d_model), act_dtype)}
    if kind == "train":
        return {"tokens": _spec((B, S), i32), "labels": _spec((B, S), i32)}
    if kind == "prefill":
        return {"tokens": _spec((B, S), i32)}
    return {"tokens": _spec((B, 1), i32)}


def decode_state_specs(cfg: ArchConfig, shape: Shape,
                       cache_dtype=torch.bfloat16) -> dict:
    """The decode state of the cell, built on ``meta`` by the model's own
    ``init_decode_state``."""
    return get_model(cfg).init_decode_state(
        cfg, shape.global_batch, decode_cache_len(cfg, shape),
        dtype=cache_dtype, device=_META)
