"""Spans and counters of the port: where a run's host time goes, and how
often each path is taken.

Tracing is on while a ``torch.profiler`` session is active, or between
:func:`enable` and :func:`disable`.

- :func:`span` ``(name, **attrs)`` is a context manager.  With tracing
  off it costs one flag check and records nothing.  With tracing on it
  keeps, in a bounded buffer (the newest :data:`MAX_SPANS`), the span's
  name, id, parent span's id, request id (the id of its root: spans
  nested under one root share it), host start and end, and its small
  integer ``attrs``; while a profiler is active it also enters a
  ``torch.profiler.record_function`` range of its name, so the span shows
  in the Chrome trace beside the device operations it launched.  On a
  CUDA device a root span adds to the counter ``cuda.device_allocs`` the
  device allocations the caching allocator made while it ran
  (``num_device_alloc``).
- :func:`count` ``(name, n=1)`` adds to an integer counter of one
  registry: always on, on the host.  :func:`counters` reports them, with
  the kernel modules' launch counts (each module's ``STATS`` stays their
  store) as ``fusion_eval.launches``, ``flash_attention.launches``,
  ``flash_attention.tensor_core``, ``flash_attention.tensor_core_tf32x3``,
  ``flash_attention.tensor_core_192_128``, ``flash_decode.launches`` and
  ``wkv6.launches``; ``counters(traced=
  True)`` reports what the registry counted while tracing was on.

:func:`spans` gives host times on the Chrome trace's clock: microseconds
since Kineto's base time (the exported trace's ``baseTimeNanoseconds``),
the clock of the ``ts`` of its events.  A reader can so set each device
operation of a trace against the innermost span the host was in at that
moment.  The base is read once a process, from an empty CPU profiler
session, so the first call of :func:`spans` outside a profiler session
takes about a second.

Spans and counters add no device operation and no host-device sync.
There is no exporter: the spans reach an operator through
``torch.profiler``, the counters through :func:`counters`.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import tempfile
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["Span", "span", "count", "counters", "spans", "enable",
           "disable", "tracing", "reset", "MAX_SPANS"]

MAX_SPANS = 1 << 16
# counter prefix -> (kernel module, its STATS fields)
_KERNEL_STATS = {"fusion_eval": ("fusion_eval", ("launches",)),
                 "flash_attention": ("flash_attention",
                                     ("launches", "tensor_core",
                                      "tensor_core_tf32x3",
                                      "tensor_core_192_128")),
                 "flash_decode": ("flash_decode", ("launches",)),
                 "wkv6": ("rwkv6_scan", ("launches",))}
_KERNELS = __name__.split(".")[0] + ".kernels."


class Span(NamedTuple):
    """One finished span; ``start_us`` and ``end_us`` on the Chrome
    trace's clock, ``parent`` None for a root, ``request`` its root's
    id."""
    name: str
    id: int
    parent: int | None
    request: int
    start_us: float
    end_us: float
    attrs: dict


_on = False
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_counts: dict[str, list[int]] = {}      # name -> [total, while tracing]
_base_ns: int | None = None
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether spans record now."""
    return _on or _profiler._is_profiler_enabled


def enable() -> None:
    """Turn tracing on outside a profiler session."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def span(name: str, **attrs):
    """A context manager that records the work inside it as one span when
    tracing is on (module docstring)."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    traced = _on or _profiler._is_profiler_enabled
    with _lock:
        c = _counts.get(name)
        if c is None:
            c = _counts[name] = [0, 0]
        c[0] += n
        if traced:
            c[1] += n


def counters(traced: bool = False) -> dict[str, int]:
    """Every counter's total and the kernels' launch counts; with
    ``traced``, what the registry's counters counted while tracing was
    on (the kernels' counts are not split so)."""
    with _lock:
        out = {k: v[1 if traced else 0] for k, v in _counts.items()}
    if not traced:
        for label, (module, fields) in _KERNEL_STATS.items():
            mod = sys.modules.get(_KERNELS + module)
            for f in fields:
                out[f"{label}.{f}"] = getattr(mod.STATS, f) if mod else 0
    return out


def spans() -> list[Span]:
    """The recorded spans in the order they ended (the newest
    :data:`MAX_SPANS`), on the Chrome trace's clock."""
    with _lock:
        raw = list(_buffer)
    if not raw:
        return []
    base = _trace_base_ns()
    return [Span(name, i, parent, req, (a - base) / 1e3, (b - base) / 1e3,
                 attrs) for name, i, parent, req, a, b, attrs in raw]


def reset() -> None:
    """Drop every span and zero every counter, the kernels' included; the
    buffer takes :data:`MAX_SPANS` as it is now."""
    global _buffer
    with _lock:
        _buffer = collections.deque(maxlen=MAX_SPANS)
        _counts.clear()
    for module, _ in _KERNEL_STATS.values():
        mod = sys.modules.get(_KERNELS + module)
        if mod is not None:
            mod.reset_launches()


class _Open:
    """A span while it runs."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "allocs",
                 "rf", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.request = self.id if up is None else up.request
        self.allocs = _device_allocs() if up is None else None
        self.rf = None
        self.t0 = time.time_ns()
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.time_ns()
        if self.allocs is not None:
            now = _device_allocs()
            if now is not None:
                count("cuda.device_allocs", now - self.allocs)
        rec = (self.name, self.id, self.parent, self.request, self.t0, t1,
               self.attrs)
        with _lock:
            if len(_buffer) == _buffer.maxlen:
                c = _counts.setdefault("obs.spans_dropped", [0, 0])
                c[0] += 1
                c[1] += 1
            _buffer.append(rec)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _device_allocs() -> int | None:
    """The caching allocator's device allocations so far on the current
    CUDA device, or None off CUDA."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_stats_as_nested_dict().get("num_device_alloc")


def _trace_base_ns() -> int:
    """Kineto's base time of the Chrome trace's ``ts``, in Unix
    nanoseconds (0 where a trace gives Unix time itself)."""
    global _base_ns
    if _base_ns is None:
        if _profiler._is_profiler_enabled:
            raise RuntimeError("obs.spans: the trace clock's base is read "
                               "outside a profiler session; call spans() "
                               "once the session has ended")
        acts = [torch.profiler.ProfilerActivity.CPU]
        with tempfile.TemporaryDirectory(prefix="obs_clock_") as d:
            with torch.profiler.profile(activities=acts) as prof:
                pass
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                _base_ns = int(json.load(f).get("baseTimeNanoseconds", 0))
    return _base_ns
