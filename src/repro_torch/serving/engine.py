"""MapperEngine: the serving core over the batched one-shot episode.

Port of ``repro.serving.engine``.  Layer map -- each layer only talks to
the one below:

 - **core** (``core.infer``): the batched episode.  Everything that varies
   per request -- workload, batch, budget, accelerator -- is per-row data
   of one episode over stacked rows (``infer._fused_batch``), so a mixed
   batch of networks is served in one episode on the card;
 - **engine** (this module): the model plus everything an episode must
   not recompute per request -- a packed-workload cache of device tensors,
   shape bucketing (``bucketing``: pow2 request batches x ``nmax``
   buckets), oversized-tick chunking (``bucketing.pow2_chunks``), and a
   solved-strategy cache with a persistent cross-process file layer
   (``cache.StrategyCache``), and optional data-parallel device replicas
   (``replicas.ReplicaGroup``);
 - **front door** (``scheduler.AsyncMapperScheduler``,
   ``examples/serve_mapper_torch.py``): accepts a request stream, forms
   ticks, calls :meth:`MapperEngine.serve`.

Determinism contract: by default the solving identity of a request is its
EXACT condition ``(workload, batch, f32 budget, accel)`` -- dedup and cache
hits only ever reuse a strategy solved under the very same condition -- so
batched and coalesced serving is bit-identical to serving each request
alone, independent of arrival order and tick formation.
``approx_budget_sharing=True`` restores quantized budget keys (higher hit
rates, per-request validity still re-derived) at the cost of that
per-request bit-identity.

Signature accounting: eager PyTorch compiles nothing, but every episode
the engine runs has a shape signature ``(nmax bucket, padded lanes)`` from
a closed set; ``compile_count`` counts the distinct signatures
materialized (the name and meaning of the reference's stats schema).
After :meth:`warmup` covers the set, steady-state serving never grows it:
oversized ticks are cut into warmed pow2 chunks.

Each chunk is one ``infer._fused_batch`` call on stacked device rows and
one copy of its results to the host.  The optional refinement stages
(``polish``, ``escalate``) score candidates through
``cost_model.evaluate_grid``: ``fusion_eval`` launches on the card.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core import cost_model as cm
from ..core import infer as _infer
from ..core import polish as _polish
from ..core import portfolio as _portfolio
from ..core.accel import AccelConfig, accel_features, hw_array
from ..core.backend import backend_for
from ..core.gsampler import _fitness
from ..core.model import param_tree
from .bucketing import (MB, batch_bucket, budget_bucket, coalesce,
                        default_nmax_buckets, nmax_bucket, pow2_buckets,
                        pow2_chunks)
from .cache import StrategyCache
from .config import ServingConfig, _ENGINE_FIELDS, config_from_kwargs
from .drift import DriftMonitor, ReplayRecord
from .replicas import ReplicaGroup

__all__ = ["MapRequest", "MapResponse", "MapperEngine"]


@dataclass(frozen=True)
class MapRequest:
    """One mapping query: "map ``workload`` at ``batch`` under
    ``budget_bytes`` of on-chip buffer on ``accel``".

    ``workload`` is a ``repro_torch.workloads.Workload``; its ``name`` is
    the cache identity, so distinct networks must carry distinct names."""
    workload: object
    batch: int
    budget_bytes: float
    accel: AccelConfig


@dataclass
class MapResponse:
    """The solved mapping for one request.

    ``strategy`` is trimmed to the workload's true ``n + 1`` positions
    (positions the padded episode masked to SYNC are dropped).  ``valid``
    is re-derived against THIS request's budget at serving precision (f32,
    matching the device comparison) even when the strategy came from the
    cache.  ``cached`` marks a strategy-cache hit or an in-tick duplicate
    (no extra device work)."""
    workload: str
    strategy: np.ndarray
    latency: float
    peak_mem: float
    speedup: float
    valid: bool
    cached: bool


@functools.lru_cache(maxsize=1024)
def _accel_key(accel: AccelConfig) -> tuple:
    """Quantized accelerator identity for strategy-cache keys: the same
    normalized ``accel_features`` the model conditions on, rounded so f32
    noise cannot split one physical device into many keys."""
    feats = accel_features(accel).numpy().astype(np.float64)
    return tuple(np.round(feats, 6).tolist())


def _fits(peak: float, budget: float) -> bool:
    """Budget validity at serving precision: the device compares f32 peak
    to the f32 budget it was handed, so every host-side re-derivation
    compares in f32 too -- a cache hit can never flip validity against the
    device answer for the same condition."""
    return bool(np.float32(peak) <= np.float32(budget))


def _fingerprint(model) -> str:
    """Checkpoint identity for persisted caches: a sha256 over the config's
    repr and each state-dict entry's name and bytes, in name order.  Two
    engines share cache files iff they would answer alike."""
    h = hashlib.sha256(repr(model.cfg).encode())
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _host(res: dict) -> dict:
    """An episode's results as host numpy arrays, in one device-to-host
    copy: strategy [C, P] int32; latency, peak_mem, speedup [C] f32; valid
    [C] bool (strategies are small ints, exact in f32)."""
    P = res["strategy"].shape[1]
    pack = torch.cat([res["strategy"].to(torch.float32), torch.stack(
        [res["latency"], res["peak_mem"], res["speedup"],
         res["valid"].to(torch.float32)], dim=1)], dim=1).cpu().numpy()
    return dict(strategy=pack[:, :P].astype(np.int32),
                latency=pack[:, P].copy(), peak_mem=pack[:, P + 1].copy(),
                speedup=pack[:, P + 2].copy(), valid=pack[:, P + 3] > 0.5)


class MapperEngine:
    """One model serving heterogeneous traffic from a closed set of
    episode signatures.

    Canonical construction takes a frozen ``config.ServingConfig`` -- the
    one record of a deployment -- via :meth:`from_config`, the ``config=``
    keyword or the top-level ``repro_torch.serve`` factory.  The older
    scattered kwargs (``cache_path``, ``checkpoint_id``,
    ``approx_budget_sharing``, ...) keep working through a deprecation
    shim that warns once per kwarg per process.

    ``model`` is a mapper of a registered backend -- the port's ``DT`` or
    its ``S2S`` -- whose config rides on it as ``.cfg``; it must already
    be on ``device`` (``cuda`` unless ``"cpu"``).

    Config fields: ``nmax_buckets`` -- the workload-length buckets
    (default ``bucketing.default_nmax_buckets``; ``cfg.max_steps`` caps
    the largest usable bucket); ``max_coalesce`` -- the widest episode the
    engine will form (wider ticks chunk); ``strategy_capacity`` -- LRU
    size; ``budget_quantum`` + ``approx_budget_sharing`` -- the
    strategy-cache budget identity (exact f32 by default); ``cache_path``
    -- persistent strategy-cache file, read-through loaded at init;
    ``checkpoint_id`` -- cache identity override (defaults to a model
    fingerprint); ``replicas`` -- a ``ReplicaGroup`` or replica count for
    data-parallel multi-device serving; ``repair`` -- the inference-time budget guard;
    ``polish`` / ``escalate`` -- the opt-in refinement stages; ``drift`` /
    ``known_accels`` / ``known_workloads`` -- the closed-loop monitor."""

    def __init__(self, model, *, config: ServingConfig | None = None,
                 device=None, **legacy):
        if config is None:
            config = config_from_kwargs("MapperEngine", _ENGINE_FIELDS,
                                        legacy)
        elif legacy:
            raise TypeError(
                "pass either config= or the legacy engine kwargs, not "
                "both: got config= plus " + ", ".join(sorted(legacy)))
        dev = resolve_device(device)
        have = next(model.parameters()).device
        if have != dev:
            raise ValueError(f"model is on {have}, the engine serves on "
                             f"{dev}")
        cfg = model.cfg
        nmax_buckets = config.nmax_buckets
        if nmax_buckets is None:
            nmax_buckets = default_nmax_buckets(cfg.max_steps)
        if max(nmax_buckets) > cfg.max_steps:
            raise ValueError(
                f"nmax bucket {max(nmax_buckets)} exceeds the model's "
                f"max_steps={cfg.max_steps} trajectory capacity")
        self.serving_config = config
        self.device = dev
        self.model = model
        self.cfg = cfg
        self.backend = backend_for(cfg)          # fail early on bad cfg
        self.repair = config.repair
        self.polish = bool(config.polish)
        self.escalate = bool(config.escalate)
        self._polish_cfg = _polish.PolishConfig()
        self._portfolio_cfg = _portfolio.PortfolioConfig(
            population=16, generations=12)
        self.nmax_buckets = tuple(sorted(nmax_buckets))
        self.max_coalesce = batch_bucket(config.max_coalesce)
        self.budget_quantum = float(config.budget_quantum)
        self.approx_budget_sharing = bool(config.approx_budget_sharing)
        self.checkpoint_id = config.checkpoint_id or _fingerprint(model)
        self.strategies = StrategyCache(config.strategy_capacity, context={
            "checkpoint": self.checkpoint_id,
            "budget_sharing": ("approx" if self.approx_budget_sharing
                               else "exact"),
            "budget_quantum": self.budget_quantum,
        })
        self.cache_path = config.cache_path
        if self.cache_path is not None:
            self.strategies.load(self.cache_path)
        self.monitor = DriftMonitor(config.drift,
                                    known_accels=config.known_accels,
                                    known_workloads=config.known_workloads)
        replicas = config.replicas
        if isinstance(replicas, int):
            replicas = ReplicaGroup(replicas)
        self.replicas = replicas
        if replicas is not None and replicas.n > self.max_coalesce:
            raise ValueError(f"{replicas.n} replicas need max_coalesce >= "
                             f"{replicas.n}, got {self.max_coalesce}")
        self._models = (replicas.replicate_params(model)
                        if replicas is not None else [model])
        self.scheduler = None                    # backref set by the scheduler
        self._packed: dict = {}                  # (name, bpe, nmax) -> tensors
        self._hw_rows: dict = {}                 # accel -> (hw [10], feats)
        self._compiled: set = set()              # (nmax bucket, padded lanes)
        self._warmed_cap: int | None = None      # widest warmed lane count
        self.compile_count = 0
        self.requests_served = 0
        self.device_calls = 0
        self.rows_padded = 0
        self.tick_dedup = 0
        self.swaps_accepted = 0
        self.swaps_rejected = 0
        self.cache_invalidated = 0
        self.coalesce_hist: dict[int, int] = {}  # true chunk width -> count
        # -- propose-then-polish accounting --
        self.escalations = 0                     # lanes sent to the portfolio
        self.polish_invocations = 0              # lanes gradient-polished
        self.polish_improved = 0                 # lanes polish strictly won
        self.wins: list[dict] = []               # flywheel: improved lanes
        self._wins_cap = 512
        self.polish_wall_s = 0.0                 # host seconds in each stage
        self.escalate_wall_s = 0.0               # (each ends in a host read)

    @classmethod
    def from_config(cls, model, config: ServingConfig | None = None, *,
                    device=None):
        """Canonical construction: one frozen :class:`ServingConfig`
        describes the whole deployment (the scheduler fields are consumed
        by ``AsyncMapperScheduler`` / ``repro_torch.serve``)."""
        return cls(model, config=config or ServingConfig(), device=device)

    # -- request planning ----------------------------------------------------

    @property
    def chunk_cap(self) -> int:
        """Widest episode the engine currently forms: the warmed pow2 cap
        once :meth:`warmup` has run, else ``max_coalesce``."""
        return self._warmed_cap or self.max_coalesce

    def _pack(self, workload, accel: AccelConfig, nmax: int) -> dict:
        """Packed-workload cache of device tensors, so a tick stacks on the
        device: packing depends on the accelerator only through
        ``bytes_per_elem`` (the cost model rescales per row), so the key is
        (name, bpe, nmax)."""
        key = (workload.name, float(accel.bytes_per_elem), nmax)
        wl = self._packed.get(key)
        if wl is None:
            wl = self._packed[key] = cm.pack_workload(workload, accel, nmax,
                                                      device=self.device)
        return wl

    def _hw_row(self, accel: AccelConfig) -> tuple:
        """Cached (raw hw row, normalized feature row) on the device."""
        ent = self._hw_rows.get(accel)
        if ent is None:
            raw = hw_array(accel, self.device)
            feat = accel_features(raw) if self.cfg.hw_dim else None
            ent = self._hw_rows[accel] = (raw, feat)
        return ent

    def _strategy_key(self, req: MapRequest) -> tuple:
        if self.approx_budget_sharing:
            bid = budget_bucket(req.budget_bytes, self.budget_quantum)
        else:
            bid = float(np.float32(req.budget_bytes))  # serving precision
        return (req.workload.name, int(req.batch), bid, _accel_key(req.accel))

    # -- serving -------------------------------------------------------------

    def serve(self, requests: list[MapRequest]) -> list[MapResponse]:
        """Solve one arrival tick of requests.

        Strategy-cache hits are answered without device work; misses are
        deduplicated within the tick (identical condition keys share one
        lane), coalesced by ``nmax`` bucket, chunked to at most
        :attr:`chunk_cap` lanes, padded to a pow2 request batch, and
        served in batched episodes.  Responses keep the request order."""
        out: list = [None] * len(requests)
        pending: dict = {}                       # key -> miss record
        for i, req in enumerate(requests):
            key = self._strategy_key(req)
            if key in pending:                   # in-tick duplicate: one lane
                pending[key][2].append((i, req))
                self.tick_dedup += 1
                continue
            hit = self.strategies.get(key)
            if hit is not None:
                out[i] = self._hit_response(req, hit)
            else:
                pending[key] = (key, req, [(i, req)])
        groups = coalesce(
            pending.values(),
            lambda m: nmax_bucket(m[1].workload.n + 1, self.nmax_buckets))
        for nb, group in groups.items():
            self._serve_bucket(nb, group, out)
        self.requests_served += len(requests)
        for req, resp in zip(requests, out):
            self._observe(req, resp)
        return out

    def serve_one(self, request: MapRequest) -> MapResponse:
        return self.serve([request])[0]

    def serve_cached(self, request: MapRequest) -> MapResponse | None:
        """Answer from the strategy cache alone, or None on a miss.

        The scheduler's admission fast path: a hit resolves immediately
        instead of queueing for a tick.  A hit counts exactly like one
        inside :meth:`serve`; a miss does NOT count -- the request will
        queue and re-probe in its tick, and that probe is the one real
        miss."""
        key = self._strategy_key(request)
        if key not in self.strategies:           # peek: miss counted in serve
            return None
        hit = self.strategies.get(key)
        if hit is None:
            return None
        self.requests_served += 1
        resp = self._hit_response(request, hit)
        self._observe(request, resp)
        return resp

    def _observe(self, req: MapRequest, resp: MapResponse) -> None:
        """Feed the replay/telemetry stream: one record per served request.
        ``warmup`` traffic bypasses (it goes straight to ``_serve_bucket``
        and is synthetic, not served demand)."""
        self.monitor.observe(ReplayRecord(
            req.workload, int(req.batch), float(req.budget_bytes),
            req.accel, bool(resp.valid), bool(resp.cached),
            float(resp.speedup)))

    def _hit_response(self, req: MapRequest, entry: tuple) -> MapResponse:
        strat, lat, peak, speed = entry
        return MapResponse(req.workload.name, strat, lat, peak, speed,
                           valid=_fits(peak, req.budget_bytes), cached=True)

    def _serve_bucket(self, nb: int, group: list, out: list) -> None:
        """Solve one group of miss records ``(key, req, [out indices])``
        sharing an ``nmax`` bucket, in episodes of at most
        :attr:`chunk_cap` lanes each (a group wider than the warmed set is
        cut into warmed pow2 chunks)."""
        start = 0
        for width in pow2_chunks(len(group), self.chunk_cap):
            self._serve_chunk(nb, group[start:start + width], out)
            start += width

    def _serve_chunk(self, nb: int, group: list, out: list) -> None:
        C = len(group)
        Cb = batch_bucket(C)
        if self.replicas is not None:
            Cb = self.replicas.pad_width(Cb)     # >= one lane per replica
        rows = [self._pack(r.workload, r.accel, nb) for _, r, _ in group]
        hw_raw, hw_feat = zip(*(self._hw_row(r.accel) for _, r, _ in group))
        batches = [np.float32(r.batch) for _, r, _ in group]
        budgets = [np.float32(r.budget_bytes) for _, r, _ in group]
        pad = Cb - C
        if pad:                                  # clone a real row: lanes
            rows += rows[:1] * pad               # are independent
            hw_raw += hw_raw[:1] * pad
            hw_feat += hw_feat[:1] * pad
            batches += batches[:1] * pad
            budgets += budgets[:1] * pad
            self.rows_padded += pad
        sig = (nb, Cb)
        if sig not in self._compiled:
            self._compiled.add(sig)
            self.compile_count += 1
        wl = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        hwv = torch.stack(hw_raw)
        hwf = None if hw_feat[0] is None else torch.stack(hw_feat)
        batches = np.asarray(batches, np.float32)
        budgets = np.asarray(budgets, np.float32)
        res = self._episode(wl, batches, budgets, hwv, hwf)
        self.device_calls += 1
        self.coalesce_hist[C] = self.coalesce_hist.get(C, 0) + 1
        if self.polish or self.escalate:
            self._refine_chunk(res, group, wl, batches, budgets, hwv)
        for lane, (key, req, idxs) in enumerate(group):
            strat = np.asarray(res["strategy"][lane][: req.workload.n + 1])
            peak = float(res["peak_mem"][lane])
            entry = (strat, float(res["latency"][lane]), peak,
                     float(res["speedup"][lane]))
            self.strategies.put(key, entry)
            # in-tick duplicates share the lane.  Under the default exact
            # budget identity every duplicate carries the SAME budget, so
            # the device's own validity applies to all of them; under
            # approx sharing a duplicate may carry a different (same-
            # bucket) budget and validity is re-derived, f32-faithfully,
            # against its own budget.
            for k, (i, req_i) in enumerate(idxs):
                valid = (bool(res["valid"][lane])
                         if req_i.budget_bytes == req.budget_bytes
                         else _fits(peak, req_i.budget_bytes))
                out[i] = MapResponse(req_i.workload.name, *entry,
                                     valid=valid, cached=k > 0)

    def _episode(self, wl: dict, batches: np.ndarray, budgets: np.ndarray,
                 hwv, hwf) -> dict:
        """One chunk's batched episode, results on the host.  With
        replicas, each replica's rows run on its device (every share
        dispatched before any is read) under the whole chunk's
        ``max_batch``, so each row meets the same guard as unsplit."""
        tick = dict(wl, __batches=torch.as_tensor(batches, device=self.device),
                    __budgets=torch.as_tensor(budgets, device=self.device),
                    __hw=hwv, __hwf=hwf)
        max_batch = batches.max()
        if self.replicas is None:
            shares = [tick]
        else:
            shares = self.replicas.shard_tick(tick, len(batches))
            self.replicas.account_rows(len(batches))
        outs = []
        for i, share in enumerate(shares):
            if share is None:
                continue
            rows = {k: v for k, v in share.items() if not k.startswith("__")}
            ctx = self.replicas.on(i) if self.replicas is not None \
                else contextlib.nullcontext()
            with ctx:
                outs.append(_infer._fused_batch(
                    self._models[i], rows, share["__batches"],
                    share["__budgets"], share["__hw"], share["__hwf"],
                    repair=self.repair, max_batch=max_batch))
        hosts = [_host(o) for o in outs]
        return {k: np.concatenate([h[k] for h in hosts]) for k in hosts[0]}

    # -- propose-then-polish escalation --------------------------------------

    def _refine_chunk(self, res: dict, group: list, wl: dict,
                      batches: np.ndarray, budgets: np.ndarray,
                      hwv: torch.Tensor) -> None:
        """Refine one chunk's one-shot proposals in place.

        Stage 1 (``polish=True``): gradient-polish EVERY lane of the chunk
        in one ``core.polish.polish_grid`` call -- the polisher is RNG-free
        and lane-independent, so refined responses keep the tick
        invariance of the one-shot path.  Stage 2 (``escalate=True``):
        lanes STILL budget-violating are routed through a short
        warm-started DE run seeded from the (polished) proposal; constant
        salts keep the escalation stream independent of which lanes of
        which tick escalate.  Both stages only ever replace a lane when the
        replacement scores strictly better under the teacher's fitness
        (valid beats invalid; then latency; then budget overshoot), so
        refinement never worsens a response."""
        C = len(group)
        base = res["speedup"] * np.maximum(res["latency"], 1e-30)
        improved = np.zeros(len(res["strategy"]), bool)
        if self.polish:
            t0 = time.perf_counter()
            p = _polish.polish_grid(wl, res["strategy"], batches, budgets,
                                    hwv, cfg=self._polish_cfg,
                                    device=self.device)
            self.polish_wall_s += time.perf_counter() - t0
            self.polish_invocations += C
            self.polish_improved += int(np.count_nonzero(p["improved"][:C]))
            improved |= p["improved"]
            res["strategy"] = np.asarray(p["strategy"])
            res["latency"] = np.asarray(p["latency"], res["latency"].dtype)
            res["peak_mem"] = np.asarray(p["peak_mem"],
                                         res["peak_mem"].dtype)
            res["valid"] = np.asarray(p["valid"])
            res["speedup"] = base / np.maximum(res["latency"], 1e-30)
        if self.escalate:
            idx = np.nonzero(~np.asarray(res["valid"][:C], bool))[0]
            if idx.size:
                t0 = time.perf_counter()
                self.escalations += int(idx.size)
                kb = batch_bucket(int(idx.size))
                take = np.concatenate(
                    [idx, np.full(kb - idx.size, idx[0], idx.dtype)])
                rows = torch.as_tensor(take, device=self.device)
                r = _portfolio.de_search_grid(
                    None, hwv[rows], batches[take], budgets[take],
                    cfg=self._portfolio_cfg,
                    init_strategies=res["strategy"][take],
                    salts=np.zeros(kb, np.uint32),
                    packed={k: v[rows] for k, v in wl.items()},
                    device=self.device)
                for j, lane in enumerate(idx):
                    cur = float(_fitness(float(res["latency"][lane]),
                                         float(res["peak_mem"][lane]),
                                         float(budgets[lane])))
                    esc = float(_fitness(float(r.latency[j]),
                                         float(r.peak_mem[j]),
                                         float(budgets[lane])))
                    if esc > cur:
                        res["strategy"][lane] = r.strategies[j]
                        res["latency"][lane] = r.latency[j]
                        res["peak_mem"][lane] = r.peak_mem[j]
                        res["valid"][lane] = bool(r.valid[j])
                        res["speedup"][lane] = base[lane] / max(
                            float(r.latency[j]), 1e-30)
                        improved[lane] = True
                self.escalate_wall_s += time.perf_counter() - t0
        # flywheel: refined wins become teacher elites at the next refresh
        for lane in range(C):
            if not (improved[lane] and bool(res["valid"][lane])):
                continue
            _, req, _ = group[lane]
            self.wins.append({
                "workload": req.workload,
                "accel": req.accel,
                "batch": int(req.batch),
                "budget_bytes": float(req.budget_bytes),
                "strategy": np.asarray(
                    res["strategy"][lane][: req.workload.n + 1],
                    np.int32).copy(),
                "latency": float(res["latency"][lane]),
                "speedup": float(res["speedup"][lane]),
            })
        if len(self.wins) > self._wins_cap:
            del self.wins[: len(self.wins) - self._wins_cap]

    def harvest_wins(self, *, workloads=None, accels=None,
                     drain: bool = True) -> list[dict]:
        """Collect (and by default drain) logged refinement wins.

        ``workloads``/``accels`` filter by name (objects or strings);
        ``None`` matches everything.  ``RefreshWorker.refresh`` harvests
        the drifted region's wins and feeds them to
        ``generate_teacher_corpus(extra_elites=...)``."""
        wset = (None if workloads is None
                else {getattr(w, "name", w) for w in workloads})
        aset = (None if accels is None
                else {getattr(a, "name", a) for a in accels})
        kept, got = [], []
        for w in self.wins:
            match = ((wset is None or w["workload"].name in wset)
                     and (aset is None or w["accel"].name in aset))
            (got if match else kept).append(w)
        if drain:
            self.wins = kept
        return got

    # -- persistence ---------------------------------------------------------

    def save_cache(self, path=None) -> int:
        """Persist the strategy cache (merge-write; see
        ``StrategyCache.save``).  Returns the number of entries written."""
        path = path if path is not None else self.cache_path
        if path is None:
            raise ValueError("no cache path: pass one here or construct the "
                             "engine with cache_path=")
        return self.strategies.save(path)

    def load_cache(self, path=None, *, strict: bool = False) -> int:
        """Read-through load of a persisted strategy cache.  Returns the
        number of entries loaded (0 on missing/stale files unless
        ``strict``)."""
        path = path if path is not None else self.cache_path
        if path is None:
            raise ValueError("no cache path: pass one here or construct the "
                             "engine with cache_path=")
        return self.strategies.load(path, strict=strict)

    # -- hot swap ------------------------------------------------------------

    def swap_params(self, new, *, invalidate=None) -> int:
        """Swap the serving model between ticks, with no new signature.

        ``new`` is a model of the live config on the engine's device; its
        parameters' names, shapes and dtypes must equal the live model's
        (``checkpoint.upgrade_pytree`` + a new engine serve an architecture
        change).

        ``invalidate`` is an optional key predicate (see
        ``drift.region_key_predicate``) scoping which strategy-cache
        entries the new weights obsolete.  Keys OUTSIDE the scope are
        deliberately KEPT: their cached strategies were solved by the old
        weights and keep answering bit-identically.  The cache's checkpoint
        context is re-fingerprinted, so persisted files carry the new
        identity.  Returns the number of cache entries invalidated."""
        if getattr(new, "cfg", None) != self.cfg:
            raise ValueError("swap_params needs the live tree structure: a "
                             f"model of {self.cfg}, got "
                             f"{getattr(new, 'cfg', type(new).__name__)}")
        live, tree = param_tree(self.model), param_tree(new)
        if set(tree) != set(live):
            raise ValueError("swap_params needs the live tree structure; "
                             f"names differ: {sorted(set(tree) ^ set(live))}")
        for k, o in live.items():
            n = tree[k]
            if n.shape != o.shape or n.dtype != o.dtype \
                    or n.device != o.device:
                raise ValueError(
                    f"swap_params leaf mismatch at {k}: "
                    f"{tuple(n.shape)}/{n.dtype}/{n.device} vs live "
                    f"{tuple(o.shape)}/{o.dtype}/{o.device} — a swap must "
                    f"not change any serving signature (use "
                    f"checkpoint.upgrade_pytree + a new engine for "
                    f"architecture changes)")
        self.model = new
        self._models = (self.replicas.replicate_params(new)
                        if self.replicas is not None else [new])
        self.checkpoint_id = _fingerprint(new)
        self.strategies.context["checkpoint"] = self.checkpoint_id
        n = self.strategies.invalidate(invalidate) if invalidate else 0
        self.swaps_accepted += 1
        self.cache_invalidated += n
        return n

    def mark_known(self, *, accels=(), workloads=()) -> None:
        """Declare conditions in-distribution for the drift monitor --
        called with the drifted region after an accepted swap, so the
        monitor stops re-firing on traffic the refreshed weights cover."""
        self.monitor.mark_known(accels=accels, workloads=workloads)

    # -- warmup & stats ------------------------------------------------------

    def warmup(self, workloads: list, accel: AccelConfig | None = None,
               *, max_tick: int | None = None) -> int:
        """Materialize every (nmax bucket, padded lane count) signature
        traffic over ``workloads`` can hit.  Returns the number of new
        signatures.  After warmup, serving any mix of these workloads adds
        ZERO signatures for ticks of ANY size: ticks wider than the warmed
        cap are chunked into warmed pow2 episodes
        (``bucketing.pow2_chunks``), never padded up to an unwarmed one.

        ``max_tick`` (default ``max_coalesce``) bounds the warmed lane
        counts; it is clamped to ``max_coalesce`` since the engine never
        forms a wider episode."""
        if accel is None:
            accel = AccelConfig()
        if max_tick is None:
            max_tick = self.max_coalesce
        cap = batch_bucket(min(max_tick, self.max_coalesce))
        before = self.compile_count
        reps: dict[int, object] = {}
        for w in workloads:
            reps.setdefault(nmax_bucket(w.n + 1, self.nmax_buckets), w)
        for nb, w in sorted(reps.items()):
            for cb in pow2_buckets(cap):
                eff = cb if self.replicas is None \
                    else self.replicas.pad_width(cb)
                if (nb, eff) in self._compiled:
                    continue
                reqs = [MapRequest(w, 1 + i % 4, (8 + i) * MB, accel)
                        for i in range(cb)]
                sink: list = [None] * cb
                self._serve_bucket(nb, [(self._strategy_key(r), r, [(j, r)])
                                        for j, r in enumerate(reqs)], sink)
        self._warmed_cap = max(self._warmed_cap or 0, cap)
        # warmed conditions are declared in-distribution: the operator
        # warms what the deployment was built for
        self.mark_known(accels=[accel], workloads=workloads)
        return self.compile_count - before

    def stats(self) -> dict:
        """One observability dict across every serving layer: the engine's
        batching and signature counters, the strategy cache with its
        persistence counters, the drift monitor, and the attached
        scheduler's queue counters when one is driving this engine.
        ``cost_evaluator`` names what scores candidates here: the
        ``fusion_eval`` kernel on the card, its plain twin on the CPU."""
        s = {
            "requests_served": self.requests_served,
            "device_calls": self.device_calls,
            "compile_count": self.compile_count,
            "cost_evaluator": ("fusion_eval" if self.device.type == "cuda"
                               else "fusion_eval_plain"),
            "compiled_shapes": sorted(self._compiled),
            "chunk_cap": self.chunk_cap,
            "rows_padded": self.rows_padded,
            "tick_dedup": self.tick_dedup,
            "escalations": self.escalations,
            "polish_invocations": self.polish_invocations,
            "polish_improved": self.polish_improved,
            "coalesce_width_hist": dict(sorted(self.coalesce_hist.items())),
            "packed_workloads": len(self._packed),
            "strategy_hits": self.strategies.hits,
            "strategy_misses": self.strategies.misses,
            "strategy_hit_rate": self.strategies.hit_rate,
            "strategy_cache": {
                "entries": len(self.strategies),
                "capacity": self.strategies.capacity,
                "shared_hits": self.strategies.shared_hits,
                "loads": self.strategies.loads,
                "saves": self.strategies.saves,
                "stale_skipped": self.strategies.stale_skipped,
            },
            "replicas": (None if self.replicas is None
                         else self.replicas.stats()),
            "drift": {
                **self.monitor.stats(),
                "swaps_accepted": self.swaps_accepted,
                "swaps_rejected": self.swaps_rejected,
                "cache_invalidated": self.cache_invalidated,
            },
        }
        if self.scheduler is not None:
            s["scheduler"] = self.scheduler.stats()
        return s
