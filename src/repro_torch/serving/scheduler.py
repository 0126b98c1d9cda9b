"""Async serving front door: continuous batching over MapperEngine.

Port of ``repro.serving.scheduler``.  Production traffic does not arrive
in neat ticks -- requests trickle in, burst, and carry latency
expectations.  ``AsyncMapperScheduler`` turns that stream into the
engine's tick-shaped world:

 - :meth:`submit` admits a request (bounded queue -- over-capacity
   submits raise :class:`AdmissionError` instead of growing latency
   unboundedly), answers strategy-cache hits IMMEDIATELY via
   ``engine.serve_cached`` (a hit never waits for a flush), and enqueues
   misses into per-``nmax``-bucket FIFO lanes with a flush deadline;
 - :meth:`pump` forms ticks continuously: a bucket flushes when it has
   coalesced a full episode's worth of unique conditions (``max_wave``,
   default the engine's warmed chunk cap) or when its oldest request's
   deadline (``flush_ms``) comes due;
 - :meth:`drain` force-flushes everything (end of stream / shutdown).

Determinism: the scheduler only ever REARRANGES requests into ticks; the
engine's exact-condition strategy identity guarantees each unique
condition is solved once in whichever tick it first lands, and every
other occurrence reuses that bit-identical entry.  Responses are
therefore bit-identical to per-request serving, independent of arrival
order, flush deadlines and coalescing.

Results come back as :class:`MapFuture`\\ s stamped with submit/resolve
times on the scheduler's clock, which is injectable (``clock=``, or an
explicit ``now`` per call), so end-to-end latency is measurable directly.
"""
from __future__ import annotations

import time
from collections import OrderedDict

from .engine import MapperEngine, MapRequest, MapResponse
from .bucketing import nmax_bucket
from .config import ServingConfig, _SCHEDULER_FIELDS, config_from_kwargs

__all__ = ["AdmissionError", "MapFuture", "AsyncMapperScheduler"]


class AdmissionError(RuntimeError):
    """Raised by :meth:`AsyncMapperScheduler.submit` when the queue is at
    ``max_queue`` — backpressure instead of unbounded latency."""


class MapFuture:
    """A pending (or resolved) mapping request.

    ``t_submit``/``t_done`` are scheduler-clock stamps; ``latency_s`` is
    the end-to-end enqueue->response time once resolved."""

    __slots__ = ("request", "response", "done", "t_submit", "t_done")

    def __init__(self, request: MapRequest, t_submit: float):
        self.request = request
        self.response: MapResponse | None = None
        self.done = False
        self.t_submit = float(t_submit)
        self.t_done: float | None = None

    def _resolve(self, response: MapResponse, now: float) -> None:
        self.response = response
        self.done = True
        self.t_done = float(now)

    @property
    def latency_s(self) -> float:
        if not self.done:
            raise RuntimeError("future not resolved yet — pump or drain "
                               "the scheduler")
        return self.t_done - self.t_submit

    def result(self) -> MapResponse:
        if not self.done:
            raise RuntimeError("future not resolved yet — pump or drain "
                               "the scheduler")
        return self.response


class AsyncMapperScheduler:
    """Continuous-batching request scheduler over one :class:`MapperEngine`.

    Canonical construction reads ``max_queue`` (bounds
    admitted-but-unsolved requests), ``flush_ms`` (how long a lone
    request waits for tick-mates — the p99 knob) and ``max_wave`` (caps
    unique conditions per formed tick; default: the engine's warmed
    chunk cap, so a full wave is exactly one warmed episode) from a
    frozen ``config.ServingConfig`` — by default the engine's own, so
    ``AsyncMapperScheduler(engine)`` honors the deployment record the
    engine was built from.  The older scattered kwargs keep working
    identically through a once-per-process deprecation shim.
    ``clock`` is injectable for simulated-time tests and benchmarks."""

    def __init__(self, engine: MapperEngine, *,
                 config: ServingConfig | None = None,
                 clock=time.perf_counter, **legacy):
        if config is None and legacy:
            config = config_from_kwargs("AsyncMapperScheduler",
                                        _SCHEDULER_FIELDS, legacy)
        elif legacy:
            raise TypeError(
                "pass either config= or the legacy scheduler kwargs, not "
                "both: got config= plus " + ", ".join(sorted(legacy)))
        if config is None:       # inherit the engine's deployment record
            config = getattr(engine, "serving_config", None) or ServingConfig()
        if config.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got "
                             f"{config.max_queue}")
        if config.flush_ms < 0:
            raise ValueError(f"flush_ms must be >= 0, got {config.flush_ms}")
        self.engine = engine
        self.max_queue = int(config.max_queue)
        self.flush_s = float(config.flush_ms) / 1e3
        self.max_wave = config.max_wave
        self.clock = clock
        self._lanes: OrderedDict = OrderedDict()   # nmax bucket -> [MapFuture]
        self._server_free = 0.0                    # simulated-time server clock
        self.queue_depth = 0
        self.max_queue_depth = 0
        self.submitted = 0
        self.rejected = 0
        self.resolved_at_submit = 0
        self.flushes = {"width": 0, "deadline": 0, "force": 0}
        engine.scheduler = self                    # stats() backref

    # -- intake --------------------------------------------------------------

    def submit(self, request: MapRequest, now: float | None = None) -> MapFuture:
        """Admit one request; returns its :class:`MapFuture`.

        Strategy-cache hits resolve before this returns (no queueing, no
        device work).  Misses enqueue for the next tick; raises
        :class:`AdmissionError` when the queue is full."""
        now = self.clock() if now is None else now
        self.submitted += 1
        fut = MapFuture(request, now)
        hit = self.engine.serve_cached(request)
        if hit is not None:
            self.resolved_at_submit += 1
            fut._resolve(hit, now)
            return fut
        if self.queue_depth >= self.max_queue:
            self.submitted -= 1
            self.rejected += 1
            raise AdmissionError(
                f"queue at capacity ({self.max_queue}); retry after a pump")
        nb = nmax_bucket(request.workload.n + 1, self.engine.nmax_buckets)
        self._lanes.setdefault(nb, []).append(fut)
        self.queue_depth += 1
        self.max_queue_depth = max(self.max_queue_depth, self.queue_depth)
        return fut

    # -- tick formation ------------------------------------------------------

    def _wave(self) -> int:
        return self.max_wave or self.engine.chunk_cap

    def _unique_pending(self, lane: list) -> int:
        return len({self.engine._strategy_key(f.request) for f in lane})

    def pump(self, now: float | None = None, *, force: bool = False) -> int:
        """Flush every bucket lane that is ready: a full wave of unique
        conditions, an expired oldest deadline, or ``force``.  Returns
        the number of requests resolved.

        With an explicit ``now`` the scheduler runs in SIMULATED time
        (open-loop arrivals, the standard dodge around coordinated
        omission): a flushed tick starts at ``max(now, server free)``,
        its service time is the MEASURED wall duration of the device
        call, and resolve stamps land on the simulated axis — so
        p50/p99 from :attr:`MapFuture.latency_s` include both queueing
        delay and real compute.  With ``now=None`` the real clock
        drives everything."""
        simulated = now is not None
        now = self.clock() if now is None else now
        resolved = 0
        wave = self._wave()
        for nb in list(self._lanes):
            lane = self._lanes[nb]
            if not lane:
                continue
            if force:
                reason = "force"
            elif self._unique_pending(lane) >= wave:
                reason = "width"
            elif now - lane[0].t_submit >= self.flush_s:
                reason = "deadline"
            else:
                continue
            self._lanes[nb] = []
            self.queue_depth -= len(lane)
            self.flushes[reason] += 1
            wall0 = time.perf_counter()
            responses = self.engine.serve([f.request for f in lane])
            elapsed = time.perf_counter() - wall0
            if simulated:
                t_done = max(now, self._server_free) + elapsed
                self._server_free = t_done
            else:
                t_done = self.clock()
            for fut, resp in zip(lane, responses):
                fut._resolve(resp, t_done)
            resolved += len(lane)
        return resolved

    def drain(self, now: float | None = None) -> int:
        """Force-flush all queued requests; returns how many resolved."""
        return self.pump(now, force=True)

    # -- conveniences --------------------------------------------------------

    def serve_stream(self, requests: list, arrivals: list | None = None
                     ) -> list[MapResponse]:
        """Run a whole request stream through submit/pump/drain and return
        responses in request order.

        With ``arrivals`` (monotone timestamps on the scheduler's clock,
        e.g. a simulated burst process), submit/pump run in simulated
        time; otherwise the real clock drives deadlines."""
        futs = []
        for i, req in enumerate(requests):
            now = arrivals[i] if arrivals is not None else None
            futs.append(self.submit(req, now))
            self.pump(now)
        self.drain(arrivals[-1] if arrivals else None)
        return [f.result() for f in futs]

    def stats(self) -> dict:
        return {
            "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "max_queue": self.max_queue,
            "flush_ms": self.flush_s * 1e3,
            "max_wave": self._wave(),
            "submitted": self.submitted,
            "rejected": self.rejected,
            "resolved_at_submit": self.resolved_at_submit,
            "flushes": dict(self.flushes),
        }
