"""The serving stack on the card: port of ``repro.serving``.

``engine.MapperEngine`` serves a mixed stream of (network, batch, budget,
accelerator) queries through the batched one-shot episode: it buckets
request shapes into a closed set of episode signatures (``bucketing``),
caches solved strategies with a persistent cross-process file layer
(``cache.StrategyCache``), and coalesces misses into batched episodes, with
opt-in refinement by gradient polish and a warm-started DE search
(``core.polish``, ``core.portfolio``).  ``scheduler.AsyncMapperScheduler``
is the async front door: continuous batching over a live request stream
with admission control and deadline-bounded flushes.

The stack is closed-loop: one frozen ``config.ServingConfig`` is the
deployment record, ``drift.DriftMonitor`` watches the served condition
stream through a bounded replay buffer, and ``refresh.RefreshWorker``
turns drift reports into a G-Sampled teacher corpus, an off-path
fine-tune, and a quality-gated hot swap (``MapperEngine.swap_params``).

Not ported: the reference's data-parallel ``ReplicaGroup``
(``serving/replicas.py``).
"""
from .bucketing import (batch_bucket, budget_bucket, coalesce,
                        default_nmax_buckets, nmax_bucket, pow2_buckets,
                        pow2_chunks)
from .cache import CACHE_FORMAT, StrategyCache
from .config import DriftConfig, ServingConfig
from .drift import (DriftMonitor, DriftReport, ReplayBuffer, ReplayRecord,
                    region_key_predicate)
from .engine import MapperEngine, MapRequest, MapResponse
from .refresh import RefreshWorker, probe_score
from .scheduler import AdmissionError, AsyncMapperScheduler, MapFuture

__all__ = ["MapperEngine", "MapRequest", "MapResponse", "StrategyCache",
           "CACHE_FORMAT", "AsyncMapperScheduler", "MapFuture",
           "AdmissionError", "ServingConfig", "DriftConfig",
           "DriftMonitor", "DriftReport", "ReplayBuffer", "ReplayRecord",
           "region_key_predicate", "RefreshWorker", "probe_score",
           "batch_bucket", "budget_bucket", "coalesce",
           "default_nmax_buckets", "nmax_bucket", "pow2_buckets",
           "pow2_chunks"]
