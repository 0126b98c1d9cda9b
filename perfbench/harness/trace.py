"""The traced window: ``torch.profiler`` over the work of a ``--trace 1``
run, reduced to what the per-layer readers read.

The reduction is the arithmetic of ``repro_torch/profile_main_path.py``
(device busy time from the kernel events, the idle share, launches, the
kernels that take the most time), done here from the benchmark's own copy
and read from the profiler's Chrome trace (``export_chrome_trace``, written
to a temporary directory and deleted once read):

- ``ops``: every device operation (kernel, copy, fill) as (name, start,
  duration), in microseconds on the trace's clock;
- ``busy_s``: the union of those intervals within the window;
- ``window_s``: the host wall of the traced work, which ends in a
  synchronise (the ``perfbench.window`` span);
- ``layer_s``: device seconds by layer: each device operation is joined
  through its ``correlation`` to the runtime or driver call that launched
  it, and that call lies inside the innermost ``perfbench.layer.<label>``
  span (:func:`layer_spans`, which wraps the program functions a mix
  names) on its thread; a launch outside every span is under ``None``;
- ``device_ops`` and ``idle_gaps``: the contract's breakdown, the ten
  operations with the most device time and the ten longest idle spans
  summed by the host operation that was running in them.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
import os
import re
import tempfile
import time

import torch

__all__ = ["Trace", "traced", "layer_spans"]

WINDOW_SPAN = "perfbench.window"
LAYER_SPAN = "perfbench.layer."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
_WALK_BACK = 5000


class Trace:
    """The reduced trace of one window, from the Chrome trace's events."""

    def __init__(self, events: list, window_s: float):
        win = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
        lo = float(win[0]["ts"]) if win else None
        hi = lo + float(win[0]["dur"]) if win else None
        ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if lo is not None:
                a, b = max(a, lo), min(b, hi)
                if b <= a:
                    continue
            ops.append((e["name"], a, b - a,
                        (e.get("args") or {}).get("correlation")))
        ops.sort(key=lambda o: o[1])
        self.ops = [(n, a, d) for n, a, d, _ in ops]
        self.window_s = window_s
        self.busy_s, gaps = _union(self.ops, lo, hi)
        self.launches = len(ops)
        self.layer_s = _by_layer(ops, events)
        totals: dict[str, float] = {}
        for name, _, d in self.ops:
            totals[name] = totals.get(name, 0.0) + d * 1e-6
        self.device_ops = sorted(([n[:120], s] for n, s in totals.items()),
                                 key=lambda x: -x[1])[:10]
        self.idle_gaps = _label_gaps(gaps, events)

    def seconds(self, pattern: str) -> tuple[float, int]:
        """Device seconds and count of the operations whose name matches
        the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hit = [d for n, _, d in self.ops if rx.search(n)]
        return sum(hit) * 1e-6, len(hit)

    def durations(self, pattern: str) -> list[float]:
        """Seconds of each matching operation, in launch order."""
        rx = re.compile(pattern)
        return [d * 1e-6 for n, _, d in self.ops if rx.search(n)]


def _union(ops, lo, hi):
    """(busy seconds, idle gaps as (start, end) in us) of sorted ops."""
    busy = 0.0
    gaps = []
    cur_a = cur_b = None
    if lo is not None and ops and ops[0][1] > lo:
        gaps.append((lo, ops[0][1]))
    for _, a, d in ops:
        b = a + d
        if cur_b is None:
            cur_a, cur_b = a, b
        elif a <= cur_b:
            cur_b = max(cur_b, b)
        else:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
    if cur_b is not None:
        busy += cur_b - cur_a
        if hi is not None and hi > cur_b:
            gaps.append((cur_b, hi))
    return busy * 1e-6, gaps


def _innermost(spans, starts, t):
    """The label of the innermost span of ``spans`` (sorted (start, end,
    label)) that holds time ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - _WALK_BACK, -1), -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return None


def _by_layer(ops, events) -> dict:
    """Device seconds by the innermost layer span around each launch."""
    launch = {}
    spans: dict = {}
    for e in events:
        cat = e.get("cat")
        if cat in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = (e.get("tid"), float(e["ts"]))
        elif (cat == "user_annotation"
              and e.get("name", "").startswith(LAYER_SPAN)):
            spans.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"][len(LAYER_SPAN):]))
    starts = {}
    for tid, s in spans.items():
        s.sort()
        starts[tid] = [a for a, _, _ in s]
    out: dict = {}
    for _, _, d, corr in ops:
        where = launch.get(corr)
        label = None
        if where is not None and where[0] in spans:
            label = _innermost(spans[where[0]], starts[where[0]], where[1])
        out[label] = out.get(label, 0.0) + d * 1e-6
    return out


def _label_gaps(gaps, events, top: int = 10, look: int = 200):
    """The ``look`` longest gaps, each labelled by the innermost host event
    running at its midpoint, summed by label; the ``top`` largest."""
    evs = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  "host in " + e["name"][:100]) for e in events
                 if e.get("cat") in HOST_CATS and e.get("ph") == "X")
    starts = [s for s, _, _ in evs]
    out: dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:look]:
        label = (_innermost(evs, starts, 0.5 * (a + b))
                 or "host: no operation recorded")
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return sorted(([k, v] for k, v in out.items()), key=lambda x: -x[1])[:top]


@contextlib.contextmanager
def layer_spans(spans: dict):
    """While the body runs, each program function named in ``spans``
    (label -> ``"module:Qualified.name"``, a module-level function or a
    class's method) runs inside a ``perfbench.layer.<label>`` span."""
    undo = []
    try:
        for label, target in spans.items():
            mod_name, qual = target.split(":")
            owner = importlib.import_module(mod_name)
            *path, attr = qual.split(".")
            for part in path:
                owner = getattr(owner, part)
            real = getattr(owner, attr)
            setattr(owner, attr, _spanned(LAYER_SPAN + label, real))
            undo.append((owner, attr, real))
        yield
    finally:
        for owner, attr, real in reversed(undo):
            setattr(owner, attr, real)


def _spanned(name: str, fn):
    @functools.wraps(fn)
    def call(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return call


def chrome_events(prof) -> list:
    """The profiler's Chrome trace events (written to a temporary file of
    the run's ``TMPDIR``, read, and deleted)."""
    with tempfile.TemporaryDirectory(prefix="perfbench_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


@contextlib.contextmanager
def traced(spans: dict, device):
    """Profile the body, with :func:`layer_spans` of ``spans`` in place;
    yields a dict that holds ``"trace"`` (a :class:`Trace`) once the body
    has ended.  The body's work must end in a synchronise of ``device``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    box: dict = {}
    with layer_spans(spans), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            yield box
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            box["window_s"] = time.perf_counter() - t0
    box["trace"] = Trace(chrome_events(prof), box["window_s"])
