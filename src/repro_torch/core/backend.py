"""The mapper-backend registry: one rollout engine, many sequence models.

Port of ``repro.core.backend`` with only the decision transformer
registered; the seq2seq baseline comes with a later slice.  A backend is
a stateless class exposing ``forward``, ``state_init``, ``prefill`` and
``step`` (see ``model.DTBackend``)."""
from __future__ import annotations

from .model import DTBackend, DTConfig

__all__ = ["backend_for"]

_BACKENDS: dict[type, type] = {DTConfig: DTBackend}


def backend_for(cfg) -> type:
    """The backend class for a model config instance."""
    for cfg_cls, backend in _BACKENDS.items():
        if isinstance(cfg, cfg_cls):
            return backend
    raise TypeError(f"no mapper backend registered for {type(cfg).__name__}")
