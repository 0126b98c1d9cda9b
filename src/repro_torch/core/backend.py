"""The mapper-backend protocol and registry: one rollout engine, many
sequence models.

Port of ``repro.core.backend``.  A backend is a stateless class exposing
``forward``, ``state_init``, ``prefill`` and ``step``, each taking the
model first (``model.DTBackend``: per-block KV caches;
``seq2seq.S2SBackend``: the streaming LSTM state), so the host rollout,
the batched episode and the serving engine are written once and ride
either model.  A third model rides them too once its config class is
registered with :func:`register_backend`: ``backend_for`` resolves a
model's ``.cfg`` through the registry."""
from __future__ import annotations

from typing import Protocol

from .model import DTBackend, DTConfig
from .seq2seq import S2SBackend, S2SConfig

__all__ = ["MapperBackend", "backend_for", "register_backend"]


class MapperBackend(Protocol):
    """What a sequence model must expose to ride the shared rollouts.

    ``model`` is the port's module (its config rides on it as ``.cfg``);
    tensor arguments carry a leading batch axis; ``hw`` is the optional
    normalised accelerator-condition row."""

    kind: str

    @staticmethod
    def forward(model, rtg, states, actions, hw=None):
        """Teacher-forced scores [B, T] over a full trajectory."""

    @staticmethod
    def state_init(model, batch: int = 1):
        """A fresh decode state (KV caches / recurrent state)."""

    @staticmethod
    def prefill(model, state, r0, s0, hw=None):
        """Feed (r_0, s_0), predict a_0 -> (pred [B], state)."""

    @staticmethod
    def step(model, state, r_t, s_t, a_prev, hw=None):
        """Append (a_{t-1}, r_t, s_t), predict a_t -> (pred [B], state)."""


_BACKENDS: dict[type, type] = {DTConfig: DTBackend, S2SConfig: S2SBackend}


def register_backend(cfg_cls: type, backend: type) -> None:
    """Map the config class ``cfg_cls`` to ``backend`` (the extension
    point): models whose ``.cfg`` is an instance of it ride the rollouts
    and the serving engine through ``backend``."""
    _BACKENDS[cfg_cls] = backend


def backend_for(cfg) -> type:
    """The backend class for a model config instance."""
    for cfg_cls, backend in _BACKENDS.items():
        if isinstance(cfg, cfg_cls):
            return backend
    raise TypeError(f"no mapper backend registered for {type(cfg).__name__}")
