"""The plain reference of the mapper cells: the analytic layer-fusion cost
model, one strategy at a time, in float64 (numpy only).

A frozen copy, taken at commit 0916888 from ``src/repro_torch/core/
ref_model.py`` (``evaluate_ref``, ``baseline_ref``) and from
``src/repro_torch/workloads/layer.py`` (``Workload.arrays``, the
``util_cap`` rule), reading the layer tables and the accelerator fields of
the benchmark's configuration file instead of the port's objects.  Two
changes from the originals: every arithmetic result goes through ``q``
(the identity, or a rounding to a lower precision for the control), and
``naive_uniform`` is the paper's naive strategy (the largest uniform
micro-batch that fits, by bisection), which the G-Sampler seeds its
population with.  It imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np

SYNC = -1
_UTIL_MIN = 1.0 / 4096.0
COLUMNS = ("name", "K", "C", "Y", "X", "R", "S", "stride", "groups",
           "skip_src", "macs", "out_elems", "w_elems")


def _ident(x: float) -> float:
    return x


def bf16(x: float) -> float:
    """``x`` rounded to the nearest bfloat16 (ties to even)."""
    b = np.array([x], np.float32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & np.uint32(0xFFFF0000)
    return float(b.view(np.float32)[0])


def pack(net: dict, nmax: int, bytes_per_elem: float) -> dict:
    """``Workload.arrays`` of a configuration file's network entry."""
    rows = [dict(zip(COLUMNS, r)) for r in net["layers"]]
    n = len(rows)
    if n + 1 > nmax:
        raise ValueError(f"{n + 1} positions > nmax {nmax}")
    A = np.zeros(nmax); W = np.zeros(nmax); F = np.zeros(nmax)
    OE = np.ones(nmax); UC = np.ones(nmax)
    SKIP = np.full(nmax, -1, dtype=np.int64)
    A[0] = net["input_elems"] * bytes_per_elem
    for i, r in enumerate(rows, start=1):
        A[i] = r["out_elems"] * bytes_per_elem
        W[i] = r["w_elems"] * bytes_per_elem
        F[i] = r["macs"]
        OE[i] = max(r["out_elems"], 1.0)
        UC[i] = 0.08 if r["groups"] > 1 and r["groups"] == r["C"] else 1.0
        SKIP[i] = r["skip_src"]
    return dict(A=A, W=W, F=F, OE=OE, UC=UC, SKIP=SKIP, n=n)


def evaluate(wl: dict, strategy, batch: float, budget: float, hw: dict,
             q=_ident) -> dict:
    """latency (s), peak_mem and traffic (bytes), valid, n_groups of one
    strategy [P] on a packed network ``wl`` and accelerator fields ``hw``
    (the configuration's ``parts`` entry)."""
    A, W, F, OE, UC = (np.asarray(wl[k], dtype=np.float64)
                       for k in ("A", "W", "F", "OE", "UC"))
    skip = wl["SKIP"]
    n = int(wl["n"])
    B = float(batch)
    s = np.asarray(strategy, dtype=np.int64)
    lanes = q(float(hw["npe"]) * float(hw["pe_lanes"]))
    peak_macs = q(lanes * float(hw["freq_hz"]))

    is_sync = [(1 <= i <= n and s[i] < 0) for i in range(len(s))]

    def mb_of(i):
        return float(min(max(int(s[i]), 1), int(B)))

    groups: list[list[int]] = [[]]
    for i in range(1, n + 1):
        groups[-1].append(i)
        if is_sync[i] and i != n:
            groups.append([])
    groups = [g for g in groups if g]

    lats, mems, trafs = [], [], []
    for g in groups:
        l, r = g[0], g[-1]
        fused = len(g) > 1
        mem = traffic = comp = onchip = waves = 0.0
        for i in g:
            if not fused:
                mbe = B
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
            w_i = math.ceil(B / mbe)
            m_i = q(stage * A[i])
            if i == l:
                m_i = q(m_i + q(mbe * A[i - 1]))
            t_i = q(W[i] * w_i)
            if i == l:
                t_i = q(t_i + q(B * A[i - 1]))
            if i == r or is_sync[i]:
                t_i = q(t_i + q(B * A[i]))
            src = int(skip[i])
            if src >= 0:
                crossing = any(is_sync[j] for j in range(max(src, 1), i))
                if crossing:
                    t_i = q(t_i + q(2.0 * B * A[src]))
                else:
                    m_i = q(m_i + q(mbe * A[src]))
            if not fused:
                m_i = min(m_i, float(hw["stream_buf_bytes"]))
            mem = q(mem + m_i)
            traffic = q(traffic + t_i)
            util = min(max(q(mbe * OE[i] / lanes), _UTIL_MIN), UC[i])
            comp = q(comp + q(q(B * F[i] / peak_macs) / util))
            onchip = q(onchip + q(q(B * q(A[i - 1] + A[i])) + q(W[i] * w_i)))
            waves = q(waves + w_i)
        lat = q(max(comp, q(traffic / float(hw["bw_offchip"])),
                    q(onchip / float(hw["bw_onchip"])))
                + q(waves * float(hw["t_pass"])) + float(hw["t_sync"]))
        lats.append(lat); mems.append(mem); trafs.append(traffic)

    latency = 0.0
    for x in lats:
        latency = q(latency + x)
    peak = max(mems) if mems else 0.0
    return dict(latency=latency, peak_mem=peak, traffic=sum(trafs),
                valid=peak <= budget, n_groups=len(groups))


def naive_uniform(wl: dict, batch: float, budget: float, hw: dict) -> dict:
    """The paper's naive strategy: the largest uniform micro-batch that
    stages everything on chip, found by bisection; all-sync where none
    fits.  Returns its :func:`evaluate`."""
    n, P = int(wl["n"]), len(wl["A"])
    lo, hi, best = 1, int(batch), None
    while lo <= hi:
        mid = (lo + hi) // 2
        s = np.full(P, SYNC, np.int64)
        s[:n + 1] = mid
        out = evaluate(wl, s, batch, budget, hw)
        if out["valid"]:
            best, lo = out, mid + 1
        else:
            hi = mid - 1
    if best is None:
        s = np.full(P, SYNC, np.int64)
        s[0] = 1
        best = evaluate(wl, s, batch, budget, hw)
    return best


def well_formed(strategy, n: int, batch: int) -> bool:
    """A strategy the cost model's format allows: position 0 a micro-batch
    in [1, batch], positions 1..n SYNC or in [1, batch], padding SYNC."""
    s = np.asarray(strategy)
    body = s[1:n + 1]
    return (1 <= s[0] <= batch and bool(np.all((body == SYNC)
                                               | ((body >= 1)
                                                  & (body <= batch))))
            and bool(np.all(s[n + 1:] == SYNC)))
