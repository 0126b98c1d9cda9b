"""The mapper-backend registry: one rollout engine, many sequence models.

Port of ``repro.core.backend``.  A backend is a stateless class exposing
``forward``, ``state_init``, ``prefill`` and ``step``, each taking the
model first (``model.DTBackend``: per-block KV caches;
``seq2seq.S2SBackend``: the streaming LSTM state), so the host rollout,
the batched episode and the serving engine are written once and ride
either model."""
from __future__ import annotations

from .model import DTBackend, DTConfig
from .seq2seq import S2SBackend, S2SConfig

__all__ = ["backend_for"]

_BACKENDS: dict[type, type] = {DTConfig: DTBackend, S2SConfig: S2SBackend}


def backend_for(cfg) -> type:
    """The backend class for a model config instance."""
    for cfg_cls, backend in _BACKENDS.items():
        if isinstance(cfg, cfg_cls):
            return backend
    raise TypeError(f"no mapper backend registered for {type(cfg).__name__}")
