"""The program's own spans and counters (``repro_torch.runtime.obs``), read
after a traced pass, and the device's idle time set against them.

A program that has no ``obs`` module (one older than its spans) gives
nothing to read: :func:`obs` returns None, and so does every reader that
needs it.  Span times are on the Chrome trace's clock (``obs.spans``), as
are ``Trace.ops``; but the profiler's device timestamps drift against its
host timestamps within one pass on the H100 machine (up to 17.6 ms over
a 2.2 s pass, growing linearly once it starts).  So the device times are
first set back on the host's clock by the one launch whose span is known:
the k-th ``fusion_eval`` kernel is the launch of the k-th
``cost_model.evaluate`` span, and a kernel starts no earlier than its
span, so the device clock runs ahead of the host's by at most the
kernel's start less its span's; the least of that bound over the nearest
anchors (where the device waited for the launch) is taken as the offset.
An idle gap of the device then falls inside a span when the host was
inside it while the device waited.
"""
from __future__ import annotations

import bisect
import importlib

ANCHOR_KERNEL = "fusion_eval_kernel"
ANCHOR_SPAN = "cost_model.evaluate"
ANCHOR_REACH = 16        # anchors on each side of one offset's estimate


def obs():
    """The program's ``obs`` module, or None where the program has none."""
    try:
        return importlib.import_module("repro_torch.runtime.obs")
    except ImportError:
        return None


def _merged(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(ops) -> list:
    """The spans of time between the first and the last device operation
    of ``ops`` ((name, start, duration) in us) in which none ran."""
    busy = _merged((a, a + d) for _, a, d in ops)
    return [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]


def _overlap(gaps, spans) -> float:
    """Microseconds of ``gaps`` that lie inside the disjoint, sorted
    ``spans``."""
    total, j = 0.0, 0
    for a, b in gaps:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            total += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return total


def device_offsets(ops, recorded) -> tuple[list, list]:
    """(device start of each anchor kernel, the device clock less the
    host's there), in launch order; empty where no anchor pairs up.  The
    kernels and spans pair in order from the first, so a kernel the
    window's end cut off leaves its span unpaired."""
    kernels = [a for n, a, _ in ops if ANCHOR_KERNEL in n]
    starts = sorted(s.start_us for s in recorded if s.name == ANCHOR_SPAN)
    bound = [k - s for k, s in zip(kernels, starts)]
    r = ANCHOR_REACH
    return (kernels[:len(bound)],
            [min(bound[max(0, i - r):i + r + 1]) for i in range(len(bound))])


def idle_share(ctx, names, root: str) -> float | None:
    """The share, in %, of the device's idle time between the traced
    pass's first and last operation that falls while the host was inside
    a program span named in ``names`` (each gap set on the host's clock by
    the nearest anchor's offset, :func:`device_offsets`; none where there
    is no anchor).  None where the program records no spans, or none of
    its ``root`` spans meets the trace's operations (a pass the profiler
    did not see)."""
    mod = obs()
    ops = ctx.trace.ops
    if mod is None or not ops:
        return None
    recorded = mod.spans()
    at, off = device_offsets(ops, recorded)
    lo = ops[0][1] - (off[0] if off else 0.0)
    hi = max(a + d for _, a, d in ops) - (off[-1] if off else 0.0)
    if not any(s.name == root and s.start_us < hi and s.end_us > lo
               for s in recorded):
        return None
    gaps = idle_gaps(ops)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    if off:
        shifted = []
        for a, b in gaps:
            i = min(bisect.bisect_left(at, a), len(at) - 1)
            if i and a - at[i - 1] < at[i] - a:
                i -= 1
            shifted.append((a - off[i], b - off[i]))
        gaps = _merged(shifted)
    inside = _merged((s.start_us, s.end_us) for s in recorded
                     if s.name in names)
    return 100.0 * _overlap(gaps, inside) / idle
