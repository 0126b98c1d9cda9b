"""Solved-strategy cache: in-memory LRU + a persistent, cross-process
file layer.

Port of ``repro.serving.cache`` (pure Python, copied; the JSON layout and
``CACHE_FORMAT`` are the reference's, so a file one package writes under
a given checkpoint id loads in the other under the same id).

A mapper front door sees heavy-tailed condition traffic: the same
(network, batch, budget, accelerator) query recurs across users.  A
solved strategy is a few dozen int32s; caching it turns a repeat query
into a dictionary hit instead of an episode on the card.  Keys are the
condition identity (``MapperEngine._strategy_key``: workload id, batch,
budget id, rounded ``accel_features``), values whatever the engine stores
(strategy + metrics).

The cache is **persistent and shared**:

 - :meth:`StrategyCache.save` serializes the entries to a versioned JSON
   payload together with a ``context`` dict (cache format, checkpoint
   fingerprint, budget-sharing mode) -- a cache solved by one model
   checkpoint must never answer for another, so loads are rejected
   (counted, not raised by default) on any context mismatch;
 - :meth:`StrategyCache.load` populates a read-through **shared layer**:
   file entries don't consume LRU capacity until traffic actually touches
   them -- a get() that misses memory but hits the shared layer promotes
   the entry (counted in ``shared_hits``) -- so warm caches survive
   restarts;
 - :meth:`save` is a read-modify-write *merge*: concurrent engines
   flushing to one file union their entries instead of clobbering.

Keys/values round-trip exactly: floats survive JSON (shortest-repr
binary64), strategies are small int lists.  Counters feed
``MapperEngine.stats()``.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
from collections import OrderedDict
from typing import Hashable

import numpy as np

__all__ = ["StrategyCache", "CACHE_FORMAT"]

# bump when the serialized key/entry layout changes incompatibly
CACHE_FORMAT = 1


def _key_to_json(key: tuple) -> list:
    """(name, batch, budget_id, accel feature tuple) -> JSON-safe list."""
    name, batch, budget_id, accel = key
    return [name, int(batch), budget_id, list(accel)]


def _key_from_json(k: list) -> tuple:
    name, batch, budget_id, accel = k
    return (str(name), int(batch),
            int(budget_id) if isinstance(budget_id, int) else float(budget_id),
            tuple(float(a) for a in accel))


def _entry_to_json(entry: tuple) -> list:
    strat, latency, peak, speedup = entry
    return [np.asarray(strat).astype(int).tolist(),
            float(latency), float(peak), float(speedup)]


def _entry_from_json(e: list) -> tuple:
    strat, latency, peak, speedup = e
    return (np.asarray(strat, np.int32), float(latency), float(peak),
            float(speedup))


class StrategyCache:
    """Bounded LRU + read-through shared file layer, with hit/miss and
    persistence accounting (not thread-safe; the engine serializes
    access).

    ``context`` identifies what the entries are valid FOR — the engine
    passes its checkpoint fingerprint and budget-sharing mode — and is
    embedded in every saved payload; :meth:`load` silently skips (and
    counts) files whose context differs."""

    def __init__(self, capacity: int = 4096, *, context: dict | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.context = dict(context or {})
        self._d: OrderedDict = OrderedDict()
        self._shared: dict = {}                  # read-through file layer
        self.hits = 0
        self.misses = 0
        self.shared_hits = 0                     # hits served from the file layer
        self.loads = 0                           # entries read from files
        self.saves = 0                           # entries written to files
        self.stale_skipped = 0                   # files rejected on context

    def get(self, key: Hashable):
        """Value for ``key`` (refreshing recency) or None; counts the
        lookup as a hit/miss.  Misses consult the shared file layer and
        promote on hit."""
        try:
            v = self._d[key]
        except KeyError:
            v = self._shared.get(key)
            if v is not None:                    # promote into the LRU
                self.put(key, v)
                self.shared_hits += 1
                self.hits += 1
                return v
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def put(self, key: Hashable, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)          # evict least-recent

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:         # no counter side effects
        return key in self._d or key in self._shared

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def invalidate(self, predicate) -> int:
        """Drop every entry (LRU and shared layer) whose key satisfies
        ``predicate`` — the scoped-invalidation hook: a hot checkpoint
        swap invalidates only the drifted region's strategies, so
        non-drifted keys keep answering bit-identically from cache.
        Returns the number of DISTINCT keys removed."""
        doomed = {k for k in self._d if predicate(k)}
        doomed |= {k for k in self._shared if predicate(k)}
        for k in doomed:
            self._d.pop(k, None)
            self._shared.pop(k, None)
        return len(doomed)

    def clear(self) -> None:
        self._d.clear()
        self._shared.clear()
        self.hits = 0
        self.misses = 0
        self.shared_hits = 0

    # -- persistence ----------------------------------------------------------

    def snapshot(self) -> dict:
        """All known entries (LRU over shared) — the determinism tests
        compare these across arrival orders / replica counts."""
        out = dict(self._shared)
        out.update(self._d)
        return out

    def save(self, path) -> int:
        """Merge-write every known entry to ``path`` (atomic rename).

        Entries already in a compatible file at ``path`` are preserved
        (read-modify-write union, memory winning ties), so N engines
        flushing to one shared file accumulate instead of clobbering.
        Returns the number of entries written."""
        path = pathlib.Path(path)
        merged: dict = {}
        if path.exists():
            try:
                payload = json.loads(path.read_text())
                if self._compatible(payload):
                    for k, e in payload["entries"]:
                        merged[_key_from_json(k)] = _entry_from_json(e)
            except (json.JSONDecodeError, KeyError, ValueError, TypeError):
                pass                             # corrupt file: overwrite
        merged.update(self.snapshot())
        payload = {
            "format": CACHE_FORMAT,
            "context": self.context,
            "entries": [[_key_to_json(k), _entry_to_json(e)]
                        for k, e in sorted(merged.items())],
        }
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)                # atomic on POSIX
        except BaseException:
            pathlib.Path(tmp).unlink(missing_ok=True)
            raise
        self.saves += len(merged)
        return len(merged)

    def load(self, path, *, strict: bool = False) -> int:
        """Populate the read-through shared layer from ``path``.

        Entries stay out of the LRU until traffic touches them.  A
        missing file, or one whose format/context doesn't match, loads
        nothing (``stale_skipped`` counts it) unless ``strict``, which
        raises instead.  Returns the number of entries loaded."""
        path = pathlib.Path(path)
        if not path.exists():
            if strict:
                raise FileNotFoundError(f"no strategy cache at {path}")
            return 0
        try:
            payload = json.loads(path.read_text())
        except json.JSONDecodeError as e:
            if strict:
                raise ValueError(f"corrupt strategy cache {path}: {e}") from e
            self.stale_skipped += 1
            return 0
        if not self._compatible(payload):
            if strict:
                raise ValueError(
                    f"incompatible strategy cache {path}: saved for "
                    f"format/context {payload.get('format')}/"
                    f"{payload.get('context')} but "
                    f"this engine expects {CACHE_FORMAT}/{self.context}")
            self.stale_skipped += 1
            return 0
        n = 0
        for k, e in payload["entries"]:
            self._shared[_key_from_json(k)] = _entry_from_json(e)
            n += 1
        self.loads += n
        return n

    def _compatible(self, payload: dict) -> bool:
        return (payload.get("format") == CACHE_FORMAT
                and payload.get("context") == self.context
                and isinstance(payload.get("entries"), list))
