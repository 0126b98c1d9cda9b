"""Drift detection over the served condition stream.

Port of ``repro.serving.drift`` (pure Python, copied).  The mapper is
imitation-trained once, offline, on a fixed (workload x accel x budget)
mix, but production traffic drifts: new accelerator parts roll out, new
networks ship, budget regimes shift.  This module is the SENSE half of
the closed loop:

 - :class:`ReplayBuffer` -- a bounded telemetry buffer the engine feeds
   with every served ``(request, response)`` pair: the condition plus the
   realized cost-model outcome (valid? cached? speedup).  It doubles as
   the sampling pool the refresh worker draws probe/teacher conditions
   from;
 - :class:`DriftMonitor` -- evaluates each completed window of
   observations against :class:`DriftConfig` thresholds: unseen-accel
   rate, unseen-network rate, strategy-cache hit-rate decay vs a running
   baseline, and budget-violation rate.  Any trigger fires a typed
   :class:`DriftReport` naming the drifted REGION (the unseen accels /
   workloads and the budget range observed), which the ACT half
   (``refresh.RefreshWorker``) turns into a teacher corpus, a fine-tune,
   and a gated hot swap.

The monitor is pure host bookkeeping -- O(1) per observation, no device
work, nothing on the serving fast path but a deque append and a few
set lookups.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from .config import DriftConfig

__all__ = ["ReplayRecord", "ReplayBuffer", "DriftReport", "DriftMonitor"]

MB = float(2 ** 20)


@dataclass(frozen=True)
class ReplayRecord:
    """One served condition + its realized outcome.  Holds the live
    workload/accel OBJECTS (not just names) so the refresh worker can
    G-Sample a teacher corpus for exactly the drifted conditions."""
    workload: object            # repro_torch.workloads.Workload
    batch: int
    budget_bytes: float
    accel: object               # core.accel.AccelConfig
    valid: bool                 # realized: strategy fit the budget
    cached: bool                # strategy-cache hit (or in-tick dup)
    speedup: float


class ReplayBuffer:
    """Bounded FIFO of :class:`ReplayRecord`; oldest records drop first.
    ``total`` counts every observation ever, ``depth`` the retained
    window."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._d: deque = deque(maxlen=capacity)
        self.total = 0

    def append(self, rec: ReplayRecord) -> None:
        self._d.append(rec)
        self.total += 1

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def recent(self, n: int) -> list:
        """The most recent ``n`` records, oldest first."""
        if n >= len(self._d):
            return list(self._d)
        return list(self._d)[-n:]


@dataclass(frozen=True)
class DriftReport:
    """One window's verdict: which thresholds fired and over WHAT region.

    ``triggers`` is a tuple of trigger names (``"unseen_accel"``,
    ``"unseen_workload"``, ``"hit_rate_decay"``, ``"budget_violations"``).
    The region fields carry live objects for the refresh worker, capped
    at ``DriftConfig.max_region`` each (``region_capped`` notes when
    traffic was broader than the cap)."""
    window_index: int
    window_size: int
    unseen_accel_rate: float
    unseen_workload_rate: float
    hit_rate: float
    baseline_hit_rate: float
    violation_rate: float
    triggers: tuple = ()
    accels: tuple = ()          # drifted AccelConfig objects (deduped)
    workloads: tuple = ()       # drifted Workload objects (deduped)
    budgets_mb: tuple = ()      # budgets observed in the drifted slice
    region_capped: bool = False

    @property
    def drifted(self) -> bool:
        return bool(self.triggers)


class DriftMonitor:
    """Window-based drift detector over the replay stream.

    ``known_accels`` / ``known_workloads`` (names) define the
    in-distribution sets; the engine seeds them from ``ServingConfig``
    and extends them on ``warmup`` and accepted swaps (``mark_known``).
    When BOTH seeds are empty, the first completed window self-calibrates:
    its conditions become the known sets and that window never fires.

    The hit-rate baseline is the first non-drifted window's rate,
    exponentially updated (0.8/0.2) on every later non-drifted window —
    so a gradual regime change still registers as decay against the
    remembered good regime.  Fired reports queue in :attr:`pending`
    until the refresh worker consumes them (:meth:`pop_reports`)."""

    def __init__(self, cfg: DriftConfig | None = None, *,
                 known_accels=(), known_workloads=()):
        self.cfg = cfg or DriftConfig()
        self.known_accels = set(known_accels)
        self.known_workloads = set(known_workloads)
        self._calibrate = not (self.known_accels or self.known_workloads)
        self.replay = ReplayBuffer(self.cfg.replay_capacity)
        self._window: list = []          # records of the in-flight window
        self.windows_evaluated = 0
        self.reports_fired = 0
        self.baseline_hit_rate: float | None = None
        self.pending: list = []          # fired, unconsumed DriftReports
        self.last_report: DriftReport | None = None

    # -- stream side (engine calls this per served request) ------------------

    def observe(self, rec: ReplayRecord) -> DriftReport | None:
        """Record one served condition; returns a report when this
        observation completes a window AND the window drifted."""
        self.replay.append(rec)
        self._window.append(rec)
        if len(self._window) < self.cfg.window:
            return None
        window, self._window = self._window, []
        return self._evaluate(window)

    def mark_known(self, *, accels=(), workloads=()) -> None:
        """Extend the in-distribution sets (accepted swap / warmup)."""
        self.known_accels.update(a.name if hasattr(a, "name") else str(a)
                                 for a in accels)
        self.known_workloads.update(w.name if hasattr(w, "name") else str(w)
                                    for w in workloads)
        if self.known_accels or self.known_workloads:
            self._calibrate = False

    def pop_reports(self) -> list:
        """Drain pending reports (refresh worker's consume side)."""
        out, self.pending = self.pending, []
        return out

    # -- window evaluation ---------------------------------------------------

    def _evaluate(self, window: list) -> DriftReport | None:
        self.windows_evaluated += 1
        n = len(window)
        if self._calibrate:
            # first window with no declared training mix: adopt it
            self.mark_known(accels=[r.accel for r in window],
                            workloads=[r.workload for r in window])
            self.baseline_hit_rate = sum(r.cached for r in window) / n
            return None
        unseen_a = [r for r in window
                    if r.accel.name not in self.known_accels]
        unseen_w = [r for r in window
                    if r.workload.name not in self.known_workloads]
        a_rate = len(unseen_a) / n
        w_rate = len(unseen_w) / n
        hit_rate = sum(r.cached for r in window) / n
        viol_rate = sum(not r.valid for r in window) / n
        base = self.baseline_hit_rate
        triggers = []
        if a_rate > self.cfg.unseen_accel_rate:
            triggers.append("unseen_accel")
        if w_rate > self.cfg.unseen_workload_rate:
            triggers.append("unseen_workload")
        if base is not None and (base - hit_rate) > self.cfg.hit_rate_drop:
            triggers.append("hit_rate_decay")
        if viol_rate > self.cfg.violation_rate:
            triggers.append("budget_violations")
        if not triggers:
            # non-drifted window: update the remembered good regime
            self.baseline_hit_rate = (hit_rate if base is None
                                      else 0.8 * base + 0.2 * hit_rate)
            return None
        drifted = unseen_a + unseen_w or list(window)
        accels, wls, capped = self._region(drifted)
        budgets = sorted({round(r.budget_bytes / MB, 3) for r in drifted})
        if len(budgets) > 2 * self.cfg.max_region:
            budgets = budgets[:: max(1, len(budgets)
                                     // (2 * self.cfg.max_region))]
            capped = True
        report = DriftReport(
            window_index=self.windows_evaluated - 1, window_size=n,
            unseen_accel_rate=a_rate, unseen_workload_rate=w_rate,
            hit_rate=hit_rate,
            baseline_hit_rate=base if base is not None else hit_rate,
            violation_rate=viol_rate, triggers=tuple(triggers),
            accels=accels, workloads=wls,
            budgets_mb=tuple(budgets), region_capped=capped)
        self.reports_fired += 1
        self.pending.append(report)
        self.last_report = report
        return report

    def _region(self, records: list) -> tuple:
        """Dedup (by name) the accels/workloads of the drifted slice,
        most-frequent first, capped at ``max_region`` each."""
        def top(items, name_of):
            counts: dict = {}
            first: dict = {}
            for it in items:
                k = name_of(it)
                counts[k] = counts.get(k, 0) + 1
                first.setdefault(k, it)
            ranked = sorted(counts, key=lambda k: -counts[k])
            return ([first[k] for k in ranked[: self.cfg.max_region]],
                    len(ranked) > self.cfg.max_region)
        accels, a_cap = top([r.accel for r in records], lambda a: a.name)
        wls, w_cap = top([r.workload for r in records], lambda w: w.name)
        return tuple(accels), tuple(wls), a_cap or w_cap

    def stats(self) -> dict:
        return {
            "replay_depth": len(self.replay),
            "replay_capacity": self.replay.capacity,
            "replay_total": self.replay.total,
            "windows_evaluated": self.windows_evaluated,
            "reports_fired": self.reports_fired,
            "pending_reports": len(self.pending),
            "baseline_hit_rate": self.baseline_hit_rate,
            "known_accels": sorted(self.known_accels),
            "known_workloads": sorted(self.known_workloads),
            "last_report": (None if self.last_report is None else {
                "window_index": self.last_report.window_index,
                "triggers": list(self.last_report.triggers),
                "accels": [a.name for a in self.last_report.accels],
                "workloads": [w.name for w in self.last_report.workloads],
                "budgets_mb": list(self.last_report.budgets_mb),
            }),
        }


def region_key_predicate(workloads, accels, accel_key_fn) -> callable:
    """Build a strategy-cache invalidation predicate scoped to a drift
    region: an entry is invalidated iff its key names a drifted workload
    OR a drifted accelerator (non-drifted keys keep their entries,
    preserving bit-exact responses across a swap).

    ``accel_key_fn`` is the engine's ``_accel_key`` so the predicate
    compares in exactly the cache's accel identity."""
    wl_names = {w.name for w in workloads}
    accel_keys = {accel_key_fn(a) for a in accels}

    def pred(key: tuple) -> bool:
        name, _batch, _bid, akey = key
        return name in wl_names or akey in accel_keys
    return pred
