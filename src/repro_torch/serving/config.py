"""ServingConfig: the one construction surface for the serving stack.

Port of ``repro.serving.config`` (pure Python, copied).
:class:`ServingConfig` is the frozen record of everything a serving
deployment is: engine batching and bucketing, strategy-cache identity and
persistence, scheduler admission and flush policy, and the closed-loop
drift knobs (:class:`DriftConfig`).  Canonical construction is
``MapperEngine.from_config(model, config)`` or the top-level
``repro_torch.serve(model, config)`` factory.

The older scattered kwargs keep working: each constructor shims them into
a ``ServingConfig`` field for field, so kwarg construction is identical to
config construction, and emits a :class:`DeprecationWarning` once per
kwarg per process.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, fields

__all__ = ["DriftConfig", "ServingConfig"]

MB = float(2 ** 20)


@dataclass(frozen=True)
class DriftConfig:
    """Closed-loop drift knobs.

    The engine always keeps the bounded replay buffer and evaluates the
    monitor every ``window`` observed requests; a ``DriftReport`` fires
    when any trigger threshold is crossed.  ``known_accels`` /
    ``known_workloads`` seed the monitor's in-distribution sets (names);
    ``warmup()`` and accepted swaps extend them.  With BOTH sets empty the
    monitor self-calibrates: the first full window's conditions become
    the known sets."""
    replay_capacity: int = 4096    # bounded telemetry/replay buffer depth
    window: int = 256              # requests per drift-evaluation window
    unseen_accel_rate: float = 0.2     # trigger: unseen-accel fraction
    unseen_workload_rate: float = 0.2  # trigger: unseen-network fraction
    hit_rate_drop: float = 0.3     # trigger: absolute hit-rate decay vs baseline
    violation_rate: float = 0.5    # trigger: budget-violation fraction
    max_region: int = 4            # accels/workloads reported per region


@dataclass(frozen=True)
class ServingConfig:
    """One frozen record of a serving deployment.

    Engine fields mirror the older ``MapperEngine`` kwargs; scheduler
    fields the ``AsyncMapperScheduler`` ones; ``drift`` the closed-loop
    monitor.  ``replicas`` is a replica count or a prebuilt
    ``ReplicaGroup``; ``None`` serves single-device."""
    # -- engine --
    repair: bool = True
    nmax_buckets: tuple | None = None
    max_coalesce: int = 16
    # -- propose-then-polish escalation --
    # polish: gradient-refine every strategy-cache MISS before it is
    # cached/answered (opt-in; never worsens a response).  escalate: route
    # responses that are STILL budget-violating after the one-shot (and
    # polish, when enabled) rollout through the warm-started search
    # portfolio.  Both default off: the default serving path is the
    # one-shot episode alone.
    polish: bool = False
    escalate: bool = False
    # -- strategy cache --
    strategy_capacity: int = 4096
    budget_quantum: float = MB
    approx_budget_sharing: bool = False
    cache_path: object = None
    checkpoint_id: str | None = None
    # -- replicas --
    replicas: object = None
    # -- scheduler --
    max_queue: int = 1024
    flush_ms: float = 8.0
    max_wave: int | None = None
    # -- closed loop --
    drift: DriftConfig = field(default_factory=DriftConfig)
    known_accels: tuple[str, ...] = ()
    known_workloads: tuple[str, ...] = ()


_ENGINE_FIELDS = ("repair", "nmax_buckets", "max_coalesce",
                  "strategy_capacity", "budget_quantum",
                  "approx_budget_sharing", "cache_path", "checkpoint_id",
                  "replicas", "drift", "known_accels", "known_workloads",
                  "polish", "escalate")
_SCHEDULER_FIELDS = ("max_queue", "flush_ms", "max_wave")

# Fields accepted as direct kwargs WITHOUT a deprecation warning: they
# were born after ServingConfig, so the kwarg form is a supported
# convenience (``MapperEngine(model, polish=True)``), not a legacy
# construction surface being phased out.
_CURRENT_KWARGS = frozenset({"polish", "escalate"})

# DeprecationWarning fires once per kwarg per process -- a serving loop
# constructing engines in a loop must not drown the log.
_WARNED: set[str] = set()


def _reset_deprecation_warnings() -> None:
    """Test hook: make the once-per-process warnings fire again."""
    _WARNED.clear()


def _warn_deprecated(owner: str, name: str) -> None:
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"{owner}(..., {name}=...) is deprecated; pass "
        f"ServingConfig({name}=...) via {owner}.from_config / the config= "
        f"keyword (or repro_torch.serve) instead — the kwarg keeps working "
        f"and is identical, but will eventually be removed",
        DeprecationWarning, stacklevel=4)


def config_from_kwargs(owner: str, allowed: tuple[str, ...],
                       kwargs: dict) -> ServingConfig:
    """Shim the older scattered kwargs into a :class:`ServingConfig`.

    Field for field: the resulting config is exactly the one the caller
    would have written by hand.  Unknown kwargs raise ``TypeError`` (same
    contract as a real signature); each deprecated kwarg warns once per
    process."""
    valid = {f.name for f in fields(ServingConfig)}
    for name in kwargs:
        if name not in valid or name not in allowed:
            raise TypeError(f"{owner}() got an unexpected keyword argument "
                            f"{name!r}")
        if name not in _CURRENT_KWARGS:
            _warn_deprecated(owner, name)
    return ServingConfig(**kwargs)
