"""Naive loop model of the fusion cost model, in float64.

Port of ``repro.core.ref_model``, numpy only: one strategy at a time,
written independently from the vectorized ``cost_model`` and the
``fusion_eval`` kernel.  It is the arithmetic that ``core/optimal.py``'s
exact DP mirrors expression for expression, and the oracle the DP's
optimum is checked against.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .accel import AccelConfig

SYNC = -1
_UTIL_MIN = 1.0 / 4096.0


@dataclass
class GroupInfo:
    start: int            # first layer position (1-based chain position)
    end: int              # last layer position (inclusive)
    mem: float            # peak on-chip bytes
    traffic: float        # off-chip bytes
    compute: float        # seconds
    latency: float        # seconds (incl. overheads)


def evaluate_ref(wl_np: dict, strategy: np.ndarray, batch: float,
                 budget_bytes: float, hw: AccelConfig) -> dict:
    """Reference evaluation. ``wl_np``: numpy arrays from Workload.arrays
    scaled to bytes (same content as cost_model.pack_workload)."""
    A, W, F, OE, UC = (np.asarray(wl_np[k], dtype=np.float64)
                       for k in ("A", "W", "F", "OE", "UC"))
    skip = np.asarray(wl_np["SKIP"], dtype=np.int64)
    mask = np.asarray(wl_np["mask"])
    n = int(wl_np["n"])
    B = float(batch)
    s = np.asarray(strategy, dtype=np.int64)

    # effective / staged micro-batches
    is_sync = [(i >= 1 and i <= n and s[i] < 0) for i in range(len(s))]
    def mb_of(i):
        return float(min(max(int(s[i]), 1), int(B)))

    # split into groups
    groups: list[list[int]] = [[]]
    for i in range(1, n + 1):
        groups[-1].append(i)
        if is_sync[i] and i != n:
            groups.append([])
    groups = [g for g in groups if g]

    infos: list[GroupInfo] = []
    for g in groups:
        l, r = g[0], g[-1]
        fused = len(g) > 1
        mem = 0.0; traffic = 0.0; comp = 0.0; onchip = 0.0; waves = 0.0
        for i in g:
            if not fused:
                mbe = B            # isolated layer: one full-batch pass
                stage = mb_of(i) if not is_sync[i] else 1.0
            elif is_sync[i]:
                prev = i - 1
                if prev >= 1 and not is_sync[prev]:
                    mbe = mb_of(prev)
                elif prev == 0:
                    mbe = mb_of(0)
                else:
                    mbe = 1.0
                stage = 1.0
            else:
                mbe = mb_of(i)
                stage = mbe
            w_i = math.ceil(B / mbe)           # weight re-fetches (per wave)
            m_i = stage * A[i]                 # activation buffer only
            if i == l:
                m_i += mbe * A[i - 1]
            t_i = W[i] * w_i
            if i == l:
                t_i += B * A[i - 1]
            if i == r or is_sync[i]:
                t_i += B * A[i]
            # skip edges: crossing iff any sync strictly between src and i
            # (inclusive of src itself — a sync at src flushes the tensor),
            # which is exactly gid[src] != gid[i] in the vectorized model.
            src = int(skip[i])
            if src >= 0:
                crossing = any(is_sync[j] for j in range(max(src, 1), i))
                if crossing:
                    t_i += 2.0 * B * A[src]
                else:
                    m_i += mbe * A[src]
            if not fused:
                m_i = min(m_i, hw.stream_buf_bytes)
            mem += m_i
            traffic += t_i
            util = min(max(mbe * OE[i] / (hw.npe * hw.pe_lanes), _UTIL_MIN), UC[i])
            comp += B * F[i] / hw.peak_macs / util
            onchip += B * (A[i - 1] + A[i]) + W[i] * w_i
            waves += w_i
        lat = max(comp, traffic / hw.bw_offchip, onchip / hw.bw_onchip) \
            + waves * hw.t_pass + hw.t_sync
        infos.append(GroupInfo(l, r, mem, traffic, comp, lat))

    latency = sum(gi.latency for gi in infos)
    peak = max(gi.mem for gi in infos) if infos else 0.0
    traffic = sum(gi.traffic for gi in infos)
    return dict(latency=latency, peak_mem=peak, traffic=traffic,
                valid=peak <= budget_bytes, n_groups=len(infos),
                groups=infos)


def baseline_ref(wl_np: dict, batch: float, hw: AccelConfig) -> float:
    A, W, F, OE, UC = (np.asarray(wl_np[k], dtype=np.float64)
                       for k in ("A", "W", "F", "OE", "UC"))
    n = int(wl_np["n"]); B = float(batch)
    lat = 0.0
    for i in range(1, n + 1):
        util = min(max(B * OE[i] / (hw.npe * hw.pe_lanes), _UTIL_MIN), UC[i])
        comp = B * F[i] / hw.peak_macs / util
        t = B * (A[i - 1] + A[i]) + W[i]
        lat += max(comp, t / hw.bw_offchip, t / hw.bw_onchip) + hw.t_sync
    return lat
