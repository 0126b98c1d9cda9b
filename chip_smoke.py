#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: name, power limit, torch and CUDA versions;
2. build: ``nvcc`` builds ``kernels/csrc/{fusion_eval,flash_attention,
   flash_decode,wkv6}.cu`` for sm_90a from this checkout, all four at
   once, each with its own flags (printed beside its ptxas lines, with the
   tensor-core attention kernel's setmaxnreg split), and a probe kernel
   launches;
3. kernel against its plain version: ``fusion_eval`` and
   ``fusion_eval_plain`` on the same card inputs (every zoo part serving
   an edge packing, so the BPE rescale runs, at pop 40 and 133, and the
   nets of at most 18 layers so packed at nmax 32 and 19, one chunk of
   32 positions; the main path's P=64 grid at pop 1, 36 and 40), in each
   form (cost, stats, raw), every output bit for bit, CostOut included;
   then each form timed by its device time a call (``device_ms``) against
   its own bound, and the host time a call of ``evaluate_grid`` and
   ``evaluate_grid_stats`` (``host_us``), also with the input check's
   cache emptied before each call;
4. G-Sampler on the card: the paper's config over 120 conditions (6 CNNs
   x 5 parts x 4 budgets, batch 64, nmax 64), through the kernel;
5. DT one shot on the card: a full-width, hw-conditioned DT with seeded
   random weights answers the same 120 conditions in one batched episode,
   and its strategies are re-scored through the kernel;
6. attention kernels against their plain versions: ``flash_attention`` at
   the JAX sweep's shapes (f32 and bf16; causal, non-causal, window 96),
   at qwen3_8b's head shape and at a ragged S; ``flash_decode`` at the
   sweep's shapes, the clamp and pad cases, the card's split plan at every
   kv_len of the served steps, kv_len 1 and T, one split, a bk that does
   not divide T, a poisoned cache tail, each case called twice (one launch
   a call, the two results bit-identical), the twin handed the kernel's
   split size; within ``atol + rtol |plain|`` of 2e-5 + 2e-5 (f32, the
   JAX sweep's) or 1e-3 + 8e-3 (bf16 ``flash_decode``: one bf16 rounding
   of the output); bf16 ``flash_attention`` (the tensor-core path, which
   rounds P to bf16 before P V) within ``fa.bf16_limit``, 1e-3 + 8e-3
   |plain| + 2^-8 plain(q, k, |v|), its worst ratio also printed against
   the old limit; then each is timed against its plain version and one
   ``scaled_dot_product_attention`` call, ``flash_attention`` on both
   paths (bf16 at the scoring shape, f32 at the self-check's),
   ``flash_decode`` by its device time a call (``device_ms``) and, apart,
   its wrapper's host time a call (``host_us``);
7. scoring: qwen3_8b at full width and depth (bf16, seeded random
   weights) scores 2 x 4096 tokens through ``lm.forward``: exactly 36
   ``flash_attention`` launches, all on the tensor-core path, finite
   logits;
8. serving: ``serve_greedy("qwen3_8b", batch=4, prompt_len=1024,
   gen_len=128)`` in f32: prefill (chunked, no kernel), then 127 greedy
   decode steps, exactly 36 x 127 ``flash_decode`` launches;
9. full-width self-check: an f32 ``forward`` over the prompt and the
   generated tokens (36 ``flash_attention`` launches, all on the
   CUDA-core path) reproduces the served logits (within 1e-3 of the
   logits' largest magnitude) and the greedy tokens (near-ties counted);
10. ``wkv6`` against ``wkv6_plain``, the sequential recurrence, in f32 at
   the JAX sweep's shapes, under strong decay, at a T that is not a whole
   number of chunks, on strided inputs, at the main path's shapes with
   the default tile (rwkv6_3b's scoring shape in f32 and in bf16 r/k/v,
   the serving prefill's, the decode step T 1) and at the double buffer's
   edges (T 2, 2 x chunk + 1): y within 5e-5 + 5e-5 |plain| (the sweep's;
   see ``WKV_LONG_ATOL`` for the 1024- and 4096-step shapes), sT
   bit-equal in every case; then timed against its plain version at the
   scoring shape (f32 and bf16), the serving prefill's and a decode
   step's (device and host time);
11. scoring: rwkv6_3b at full width and depth (bf16, seeded random
   weights) scores 2 x 4096 tokens through ``rwkv_lm.forward``: exactly
   32 ``wkv6`` launches, finite logits;
12. serving: ``serve_greedy("rwkv6_3b", batch=4, prompt_len=1024,
   gen_len=128)`` in f32: exactly 32 + 32 x 127 = 4096 ``wkv6`` launches,
   32 in the prefill and one per layer in each decode step;
13. RWKV self-check: an f32 ``forward`` through ``wkv6`` over the prompt
   and the generated tokens reproduces the served logits and greedy
   tokens as in phase 9, and one prefill and one decode step each launch
   ``wkv6`` once per layer.

The last lines are the card's ``nvidia-smi`` name and power limit, a JSON
line with each kernel's launches, error and times, and
``{"ok": true, "device": {...}}``.  It imports nothing of JAX and nothing
of the JAX package, and exits non-zero without output when no CUDA device
is present or the port's sources are not beside it.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

NMAX = 64
BATCH = 64
BUDGETS_MB = (8, 16, 32, 64)
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12    # bf16 on the tensor cores, dense
FE_OPS_PER_POSITION = 48        # f32 operations of one live (candidate, pos)
FE_POPS = (1, 36, 40)           # the naive search and re-score, repair, GA
MB = 2.0 ** 20
ARCH = "qwen3_8b"
RWKV = "rwkv6_3b"
SCORE_B, SCORE_S = 2, 4096
SERVE_B, PROMPT, GEN = 4, 1024, 128
SELF_CHECK_REL = 1e-3           # served vs forward logits, x max |logit|
WKV_TOL = (5e-5, 5e-5)          # (rtol, atol): the JAX sweep's
WKV_OPS_PER_CELL = 6            # f32 operations per state cell and step
# Over rwkv6_3b's long inputs (the serving prefill's 1024 steps and
# scoring's 4096, under the model's decays) the kernel and its twin still
# share every state rounding (the kernel is written so), and differ only
# in the order of y's sum over i: 64 terms r_i (u_i k_i v_j + S_ij) with
# |S| ~ 14 once the state has filled (a few hundred steps at these
# decays).  One such f32 sum already errs by up to 0.62 x the sweep's
# limit against an f64 sum over 1e6 outputs (B1 x T4096 x H4, CPU), and
# the kernel-vs-twin difference holds two such errors over 1e7 to 2.1e7
# outputs, so the absolute part of the limit is doubled at those shapes
# only.
WKV_LONG_ATOL = 1e-4
# device_ms / host_us: the spin kernel ahead of the timed calls lasts this
# many clock cycles a call (~100 us at ~2 GHz), longer than the kernel
# wrappers' host paths, so the card never waits on the host inside the
# window; device_ms stretches it for a slower caller (a plain twin),
# counting SPIN_CLOCK_HZ cycles a second (the H100's top SM clock).
SPIN_CYCLES_PER_CALL = 2e5
SPIN_CLOCK_HZ = 1.98e9


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls run
    back to back on the card: a spin kernel holds the card while the host
    enqueues them, so CUDA events time the calls and not the host's rate
    of enqueueing them (a decode-sized kernel is shorter than its wrapper's
    host path).  The spin lasts SPIN_CYCLES_PER_CALL a call, or twice the
    host time a call measured first if that is longer."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    spin = max(SPIN_CYCLES_PER_CALL, 2 * host * SPIN_CLOCK_HZ)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin * reps))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean host microseconds per call of ``fn``: ``perf_counter`` around
    ``reps`` calls enqueued behind a spin kernel, before one synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SPIN_CYCLES_PER_CALL * reps))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def fe_bound_ms(C: int, POP: int, P: int, live_positions: int, form):
    """Least time for one fusion_eval call in ``form``: the strategies, the
    layer table, the per-condition scalars and hw rows read once, the
    CostOut and the form's group matrices (none, gid and M_g, or all
    seven) written once, over HBM; f32 operations over the f32 peak."""
    mats = (0, 2, 7)[int(form)]
    bytes_ = (C * POP * P * 4                    # strategies
              + C * P * (5 * 4 + 4)              # A W F OE UC, SKIP
              + C * (4 * 4 + 10 * 4)             # n, batch, BPE, budget, hw
              + C * POP * (3 * 4 + 1 + 4)        # CostOut
              + mats * C * POP * P * 4)          # the form's matrices
    ops = POP * live_positions * FE_OPS_PER_POSITION
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), bytes_


def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention mask leaves visible."""
    total = 0
    for i in range(S):
        hi = min(T, i + 1) if causal else T
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def roofline_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def peak_ops(dtype) -> float:
    import torch
    return H100_BF16_OPS_PER_S if dtype == torch.bfloat16 else \
        H100_F32_OPS_PER_S


def fa_bound_ms(B, S, T, Hq, Hkv, hd, causal, window, dtype):
    """Least time for one flash_attention call: 4 * hd operations per
    visible (query, key) pair and head over the peak of the input type;
    q, k, v read once and the output written once over HBM."""
    import torch
    size = torch.finfo(dtype).bits // 8
    ops = 4 * hd * visible_pairs(S, T, causal, window) * B * Hq
    nbytes = size * (2 * B * S * Hq * hd + 2 * B * T * Hkv * hd)
    return roofline_ms(nbytes, ops, peak_ops(dtype))


def fd_bound_ms(B, Hq, Hkv, hd, kv_len, dtype):
    """Least time for one flash_decode call: the kv_len visible keys and
    values read once, q read and the output written once."""
    import torch
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (2 * B * kv_len * Hkv * hd + 2 * B * Hq * hd)
    return roofline_ms(nbytes, 4 * B * Hq * kv_len * hd, peak_ops(dtype))


def sdpa_ms(q, k, v, causal: bool, reps: int) -> float:
    """One ``scaled_dot_product_attention`` call on the same inputs (the
    yardstick; the port never calls it)."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), reps)


def attention_kernels(dev) -> dict:
    """Phase 6: both attention kernels against their plain versions, then
    timed at the main path's shapes.  Returns the JSON fields."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    # (rtol, atol).  f32: the JAX sweep's 2e-5.  bf16: both sides compute in
    # f32 from the same bf16 inputs, so they may differ by one bf16 rounding
    # of the output (2^-7 relative at most), not by the sweep's 2e-2; bf16
    # flash_attention also rounds P, and is held to fa.bf16_limit instead.
    tol = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (8e-3, 1e-3)}
    worst = {}                           # max of |got - want| / limit
    fa_strict = fa_gated = 0.0           # bf16 flash_attention, old / new
    rng = np.random.default_rng(0)

    def qkv(dtype, B, S, T, Hq, Hkv, hd):
        mk = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=dtype,
                                         device=dev)
        return mk(B, S, Hq, hd), mk(B, T, Hkv, hd), mk(B, T, Hkv, hd)

    def held(label, got, want, dtype, limit=None):
        """Check got against want within atol + rtol |want|, or within the
        elementwise ``limit`` where given; return the max abs error and
        the worst ratio against the atol + rtol limit."""
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        rtol, atol = tol[dtype]
        diff = (g - w).abs()
        err = float(diff.max())
        strict = float((diff / (atol + rtol * w.abs())).max())
        ratio = strict if limit is None else float((diff / limit).max())
        if limit is None:
            worst[dtype] = max(worst.get(dtype, 0.0), ratio)
        check(ratio <= 1 and torch.isfinite(g).all(), f"{label}: kernel "
              f"differs from its plain version (max abs err {err}, "
              f"{ratio:.3g} x the limit)")
        return err, strict, ratio

    fa_cases = [(B, S, S, Hq, Hkv, hd, dt, c, w)
                for B, S, Hq, Hkv, hd in ((1, 128, 2, 2, 64),
                                          (2, 256, 4, 2, 64),
                                          (1, 256, 8, 1, 128))
                for dt in (torch.float32, torch.bfloat16)
                for c, w in ((True, -1), (False, -1), (True, 96))]
    fa_cases += [(1, S, S, 1, 1, hd, torch.bfloat16, True, -1)
                 for S in (64, 128) for hd in (64, 128)]      # one tile
    fa_cases += [(2, 384, 384, 8, 2, 64, torch.bfloat16, True, 96),
                 (2, 77, 150, 4, 4, 64, torch.bfloat16, False, -1),
                 (SCORE_B, SCORE_S, SCORE_S, 32, 8, 128, torch.bfloat16,
                  True, -1),
                 (1, SCORE_S, SCORE_S, 32, 8, 128, torch.float32, True, -1)]
    fa_cases += [(SERVE_B, PROMPT + GEN - 1, PROMPT + GEN - 1, 32, 8, 128,
                  dt, True, -1) for dt in (torch.float32, torch.bfloat16)]
    fa_err = {}
    for B, S, T, Hq, Hkv, hd, dt, c, w in fa_cases:
        q, k, v = qkv(dt, B, S, T, Hq, Hkv, hd)
        label = (f"flash_attention B{B} S{S} T{T} Hq{Hq}/{Hkv} hd{hd} "
                 f"{str(dt)[6:]} causal={c} window={w}")
        want = fa.flash_attention_plain(q, k, v, causal=c, window=w)
        limit = None
        if dt == torch.bfloat16:
            limit = fa.bf16_limit(q, k, v, causal=c, window=w, want=want)
        err, strict, ratio = held(
            label, fa.flash_attention(q, k, v, causal=c, window=w), want,
            dt, limit)
        if limit is not None:
            fa_strict, fa_gated = max(fa_strict, strict), max(fa_gated, ratio)
        fa_err[dt] = max(fa_err.get(dt, 0.0), err)
        del q, k, v, want, limit
    print(f"[6/13] flash_attention == plain on {len(fa_cases)} shapes (JAX "
          f"sweep x f32/bf16 x causal/non-causal/window 96, one tile of 64 "
          f"and 128 rows at hd 64 and 128, GQA 4:1 and 8:1, ragged S/T "
          f"77/150, qwen3_8b heads at S {SCORE_S} and at ragged S "
          f"{PROMPT + GEN - 1}): max abs err f32 {fa_err[torch.float32]:.3g}"
          f", bf16 {fa_err[torch.bfloat16]:.3g}; bf16 (tensor-core path) "
          f"worst |got - want| / limit {fa_gated:.3g} against 1e-3 + 8e-3 "
          f"|plain| + 2^-8 plain(q, k, |v|), {fa_strict:.3g} against the "
          f"old 1e-3 + 8e-3 |plain|")

    T_srv = PROMPT + GEN + 8
    fd_cases = [(B, T, Hq, Hkv, hd, kl, 256, dt, False)
                for B, T, Hq, Hkv, hd, kl in ((1, 1024, 4, 4, 64, 800),
                                              (2, 2048, 8, 2, 64, 2048),
                                              (1, 1024, 8, 1, 128, 513))
                for dt in (torch.float32, torch.bfloat16)]
    fd_cases += [(1, 72, 4, 2, 64, kl, bk, torch.float32, False)
                 for kl, bk in ((72, 512), (50, 32), (7, 16))]
    # the card's plan (bk None) at every kv_len of the 127 served steps
    fd_cases += [(SERVE_B, T_srv, 32, 8, 128, kl, None, torch.float32, False)
                 for kl in range(PROMPT + 1, PROMPT + GEN)]
    fd_cases += [(SERVE_B, T_srv, 32, 8, 128, kl, bk, dt, False)
                 for kl, bk in ((PROMPT + 1, None), (PROMPT + GEN - 1, None),
                                (1, None), (T_srv, None), (64, None),
                                (PROMPT + 40, 100), (T_srv, 512))
                 for dt in (torch.float32, torch.bfloat16)]
    fd_cases += [(SERVE_B, T_srv, 32, 8, 128, PROMPT // 2 + 1, bk,
                  torch.float32, True) for bk in (256, None)]
    fd_err, fd_plans, fd_same = {}, set(), 0
    for B, T, Hq, Hkv, hd, kl, bk, dt, poison in fd_cases:
        q, k, v = qkv(dt, B, 1, T, Hq, Hkv, hd)
        used = fd.plan(q, k, kl, bk)             # the kernel's (bk, ns)
        fd_plans.add(used)
        want = fd.flash_decode_plain(q, k, v, kl, bk=used[0])
        if poison:                       # the unwritten tail, as in JAX's
            k[:, kl:], v[:, kl:] = 1e6, -1e6      # test_kernels.py:213
        label = (f"flash_decode B{B} T{T} Hq{Hq}/{Hkv} hd{hd} kv_len {kl} "
                 f"bk {bk} (plan {used}) {str(dt)[6:]} poisoned={poison}")
        before = fd.STATS.launches
        got = fd.flash_decode(q, k, v, kl, bk=bk)
        again = fd.flash_decode(q, k, v, kl, bk=bk)
        torch.cuda.synchronize()
        check(fd.STATS.launches == before + 2, f"{label}: a call is not one "
              f"launch")
        check(torch.equal(got, again), f"{label}: two calls differ (the "
              f"merge depends on block order)")
        fd_same += 1
        err = held(label, got, want, dt)[0]
        fd_err[dt] = max(fd_err.get(dt, 0.0), err)
    print(f"      flash_decode == plain on {len(fd_cases)} shapes (JAX sweep "
          f"x f32/bf16 at bk 256, clamp/pad T 72, the card's plan at every "
          f"served kv_len {PROMPT + 1}..{PROMPT + GEN - 1}, kv_len 1, 64 (one "
          f"split) and T, bk 100 (not dividing T), bf16, poisoned tail; "
          f"plans {sorted(fd_plans)[:4]}...): max abs err f32 "
          f"{fd_err[torch.float32]:.3g}, bf16 {fd_err[torch.bfloat16]:.3g}; "
          f"two calls bit-identical on all {fd_same}, one launch a call")
    print(f"      worst |got - want| / (atol + rtol |want|) outside bf16 "
          f"flash_attention: f32 {worst[torch.float32]:.3g} (2e-5, 2e-5), "
          f"bf16 {worst[torch.bfloat16]:.3g} (8e-3, 1e-3)")

    # times at the main path's shapes: bf16 (tensor-core path) at the
    # scoring shape, f32 (CUDA-core path) at the self-check's
    q, k, v = qkv(torch.bfloat16, SCORE_B, SCORE_S, SCORE_S, 32, 8, 128)
    fa_ms = time_ms(lambda: fa.flash_attention(q, k, v), 20)
    fa_plain = time_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
    fa_lib = sdpa_ms(q, k, v, True, 20)
    want = fa.flash_attention_plain(q, k, v)
    fa_main_err = held("flash_attention at the scoring shape",
                       fa.flash_attention(q, k, v), want, torch.bfloat16,
                       fa.bf16_limit(q, k, v, want=want))[0]
    fa_bound, fa_by = fa_bound_ms(SCORE_B, SCORE_S, SCORE_S, 32, 8, 128,
                                  True, -1, torch.bfloat16)
    del q, k, v, want
    S32 = PROMPT + GEN - 1
    q, k, v = qkv(torch.float32, SERVE_B, S32, S32, 32, 8, 128)
    f32_ms = time_ms(lambda: fa.flash_attention(q, k, v), 5)
    f32_plain = time_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
    f32_lib = sdpa_ms(q, k, v, True, 5)
    f32_bound, f32_by = fa_bound_ms(SERVE_B, S32, S32, 32, 8, 128, True, -1,
                                    torch.float32)
    del q, k, v
    torch.cuda.empty_cache()
    kl = PROMPT + GEN // 2               # mean kv_len of the 127 steps
    q, k, v = qkv(torch.float32, SERVE_B, 1, T_srv, 32, 8, 128)
    fd_bk, fd_ns = fd.plan(q, k, kl)
    fd_ms = device_ms(lambda: fd.flash_decode(q, k, v, kl), 300)
    fd_host = min(host_us(lambda: fd.flash_decode(q, k, v, kl), 300)
                  for _ in range(3))
    fd_plain = time_ms(lambda: fd.flash_decode_plain(q, k, v, kl), 50)
    fd_lib = sdpa_ms(q, k[:, :kl], v[:, :kl], False, 200)
    fd_main_err = held("flash_decode at the serving shape",
                       fd.flash_decode(q, k, v, kl),
                       fd.flash_decode_plain(q, k, v, kl, bk=fd_bk),
                       torch.float32)[0]
    fd_bound, fd_by = fd_bound_ms(SERVE_B, 32, 8, 128, kl, torch.float32)
    tflops = 4 * 128 * visible_pairs(SCORE_S, SCORE_S, True, -1) \
        * SCORE_B * 32 / fa_ms / 1e9
    print(f"      flash_attention bf16, tensor-core path [B{SCORE_B} "
          f"S{SCORE_S} Hq32/8 hd128 causal]: kernel {fa_ms:.4f} ms "
          f"({tflops:.1f} TFLOP/s), plain {fa_plain:.4f} ms, sdpa "
          f"{fa_lib:.4f} ms, bound {fa_bound:.4f} ms ({fa_by})")
    print(f"      flash_attention f32, CUDA-core path [B{SERVE_B} S{S32} "
          f"Hq32/8 hd128 causal]: kernel {f32_ms:.4f} ms, plain "
          f"{f32_plain:.4f} ms, sdpa {f32_lib:.4f} ms, bound "
          f"{f32_bound:.4f} ms ({f32_by})")
    print(f"      flash_decode f32 [B{SERVE_B} T{T_srv} kv_len {kl} Hq32/8 "
          f"hd128], the card's plan bk {fd_bk} x {fd_ns} splits "
          f"({fd_ns * 8 * SERVE_B} blocks): kernel {fd_ms:.5f} ms of device "
          f"time a call, plain {fd_plain:.4f} ms, sdpa {fd_lib:.4f} ms, bound "
          f"{fd_bound:.5f} ms ({fd_by})")
    print(f"      flash_decode host path: {fd_host:.2f} us a call (best of 3 "
          f"x 300 calls enqueued before one synchronize), beside "
          f"{fd_ms * 1e3:.2f} us of device time, a {fd_bound * 1e3:.2f} us "
          f"bound and sdpa's {fd_lib * 1e3:.2f} us")
    return {"flash_attention": dict(
                max_abs_err=fa_main_err, ms=fa_ms, plain_ms=fa_plain,
                bound_ms=fa_bound, bound_by=fa_by, library_ms=fa_lib,
                path={"bfloat16": "tensor_core", "float32": "cuda_core"},
                worst_err_ratio_strict=fa_strict, worst_err_ratio=fa_gated,
                f32_ms=f32_ms, f32_plain_ms=f32_plain,
                f32_bound_ms=f32_bound, f32_library_ms=f32_lib),
            "flash_decode": dict(max_abs_err=fd_main_err, ms=fd_ms,
                                 plain_ms=fd_plain, bound_ms=fd_bound,
                                 bound_by=fd_by, library_ms=fd_lib,
                                 host_us=fd_host, bk=fd_bk, ns=fd_ns)}


def reset_counts() -> None:
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    from repro_torch.kernels import fusion_eval as fe, rwkv6_scan as rk
    for mod in (fe, fa, fd, rk):
        mod.reset_launches()


def counts() -> dict:
    """Launches per kernel, and per path of ``flash_attention``."""
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    from repro_torch.kernels import fusion_eval as fe, rwkv6_scan as rk
    return {"fusion_eval": fe.STATS.launches,
            "flash_attention": fa.STATS.launches,
            "fa_tensor_core": fa.STATS.tensor_core,
            "fa_cuda_core": fa.STATS.cuda_core,
            "flash_decode": fd.STATS.launches,
            "wkv6": rk.STATS.launches}


def launched(n: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in n.items() if v) or "none"


def expect_counts(label: str, n: dict, **want) -> None:
    """The counts are ``want`` for the named kernels and 0 for the rest."""
    full = {k: want.get(k, 0) for k in n}
    check(n == full, f"{label} launched {n}, expected {full}")


def scoring(dev, arch: str, phase: int, **want) -> dict:
    """Phases 7 and 11: ``arch`` (bf16, seeded random weights) scores
    SCORE_B x SCORE_S random tokens; the launches are ``want``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(arch)
    mod = get_model(cfg)
    t0 = time.perf_counter()
    model = mod.init(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (SCORE_B, SCORE_S)), device=dev)
    mod.forward(model, {"tokens": toks[:, :128]})         # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = mod.forward(model, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = counts()
    expect_counts(f"scoring {arch}", n, **want)
    check(tuple(logits.shape) == (SCORE_B, SCORE_S, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), "scoring logits malformed "
          "or not finite")
    print(f"[{phase}/13] scoring {arch} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {n_params / 1e9:.2f}e9 params, bf16, "
          f"seeded random weights; init {t_init:.2f} s) over "
          f"{SCORE_B}x{SCORE_S} tokens: wall {wall:.4f} s, launches "
          f"{launched(n)}, logits {tuple(logits.shape)} finite")
    del model, logits
    torch.cuda.empty_cache()
    return n


def serving(dev, arch: str, phase: int, **want) -> dict:
    """Phases 8 and 12: greedy serving of ``arch`` in f32; the launches are
    ``want``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_greedy
    cfg = get_config(arch)
    reset_counts()
    t0 = time.perf_counter()
    out = serve_greedy(arch, batch=SERVE_B, prompt_len=PROMPT, gen_len=GEN,
                       reduced=False, seed=0, device=dev, keep_logits=True)
    wall = time.perf_counter() - t0
    n = counts()
    expect_counts(f"serving {arch}", n, **want)
    toks = out["tokens"]
    check(toks.shape == (SERVE_B, GEN) and (toks >= 0).all()
          and (toks < cfg.vocab_padded).all(), "served tokens malformed")
    print(f"[{phase}/13] serving {arch} f32, batch {SERVE_B}, prompt "
          f"{PROMPT}, gen {GEN}: prefill {out['t_prefill_s']:.4f} s, decode "
          f"{out['t_decode_s']:.4f} s, {out['tok_per_s']:.2f} tok/s; wall "
          f"with init {wall:.2f} s; launches {launched(n)}")
    out["launches"] = n
    torch.cuda.empty_cache()
    return out


def self_check(dev, arch: str, served: dict, phase: int, *, want_fwd=None,
               want_prefill=None, want_step=None) -> None:
    """Phases 9 and 13: an f32 forward over prompt + generated tokens
    reproduces the served logits and the greedy tokens.  With ``want_*``,
    the forward, one prefill of the prompt and one decode step after it
    launch exactly those kernels."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(arch)
    mod = get_model(cfg)
    model = mod.init(cfg, seed=0, dtype=torch.float32, device=dev)
    seq = torch.as_tensor(
        np.concatenate([served["prompt"], served["tokens"][:, :-1]], 1),
        device=dev)
    reset_counts()
    logits = mod.forward(model, {"tokens": seq})[:, PROMPT - 1:]
    n_fwd = counts()
    if want_fwd is not None:
        expect_counts(f"{arch} f32 forward", n_fwd, **want_fwd)
    note = ""
    if want_prefill is not None:
        reset_counts()
        lg, state = mod.prefill(model, {"tokens": seq[:, :PROMPT]},
                                PROMPT + 8, cache_dtype=torch.float32)
        n_pre = counts()
        reset_counts()
        mod.decode_step(model, state, {"tokens": seq[:, PROMPT:PROMPT + 1]})
        n_step = counts()
        expect_counts(f"{arch} prefill", n_pre, **want_prefill)
        expect_counts(f"{arch} decode step", n_step, **want_step)
        note = (f"; one prefill launches {launched(n_pre)}, one decode step "
                f"{launched(n_step)}")
        del lg, state
    del model
    got = served["logits"]
    scale = float(logits.abs().max())
    err = float((logits - got).abs().max())
    err_pre = float((logits[:, 0] - got[:, 0]).abs().max())
    check(err <= SELF_CHECK_REL * scale, f"served logits differ from the "
          f"forward's by {err} (limit {SELF_CHECK_REL} x {scale})")
    arg = logits.argmax(-1).cpu().numpy()
    top2 = logits.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    diff = arg != served["tokens"]
    ties = int((diff & (gap <= 2 * err)).sum())
    check(int(diff.sum()) == ties, f"{int(diff.sum()) - ties} greedy tokens "
          f"differ from the forward's argmax beyond a near-tie")
    print(f"[{phase}/13] self-check {arch}: f32 forward over {seq.shape[0]}x"
          f"{seq.shape[1]} tokens (launches {launched(n_fwd)}) reproduces "
          f"the served logits at positions {PROMPT - 1}..{PROMPT + GEN - 2}: "
          f"max abs err {err:.4g} ({err_pre:.4g} at the prefill's position "
          f"{PROMPT - 1}) vs max |logit| {scale:.4g} (limit "
          f"{SELF_CHECK_REL} relative); argmax == greedy tokens except "
          f"{ties} near-ties (top-2 gap <= 2 x err){note}")
    del logits, got
    torch.cuda.empty_cache()


def wkv_bound_ms(B, T, H, n, dtype):
    """Least time for one wkv6 call: r, k, v (``dtype``), w and y (f32)
    read or written once, s0 and sT once; WKV_OPS_PER_CELL f32 operations
    per state cell and step."""
    import torch
    size = torch.finfo(dtype).bits // 8
    nbytes = B * T * H * n * (3 * size + 2 * 4) + 2 * B * H * n * n * 4 \
        + H * n * 4
    return roofline_ms(nbytes, WKV_OPS_PER_CELL * B * T * H * n * n,
                       H100_F32_OPS_PER_S)


def wkv_kernel(dev) -> dict:
    """Phase 10: ``wkv6`` against its plain twin, then timed at the scoring
    shape.  Returns the JSON fields."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan as rk
    cfg = get_config(RWKV)
    H, n = cfg.n_heads, cfg.hd
    rng = np.random.default_rng(0)

    def inputs(B, T, Hh, nn_, decay, dtype=torch.float32, strided=False):
        mk = lambda *sh: torch.as_tensor(rng.normal(size=sh),
                                         dtype=torch.float32, device=dev)
        if decay == "model":       # w0 = -6 plus a LoRA term within +-1
            w = np.exp(-np.exp(-6.0 + rng.uniform(-1, 1, (B, T, Hh, nn_))))
        else:
            w = rng.uniform(*decay, size=(B, T, Hh, nn_))
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        r, k, v = (mk(B, T, Hh, nn_).to(dtype) for _ in range(3))
        u, s0 = mk(Hh, nn_), mk(B, Hh, nn_, nn_)
        if strided:                # views into one [B, T, H, 4, n] buffer
            r, k, v, w = torch.stack([r, k, v, w], 3).unbind(3)
        return r, k, v, w, u, s0

    mild, strong = (0.75, 0.9995), (0.05, 0.3)
    cases = [(1, 64, 2, 32, 32, mild, torch.float32, False),
             (2, 130, 3, 64, 64, mild, torch.float32, False),
             (1, 256, 1, 16, 64, mild, torch.float32, False),
             (1, 512, 4, 64, 64, strong, torch.float32, False),
             (2, 300, 3, 64, 64, strong, torch.float32, False),
             (2, 130, 3, 64, 64, mild, torch.float32, True),
             (2, 130, 3, 64, 64, mild, torch.bfloat16, False)]
    # the main path's shapes at the default tile (chunk None), as the
    # models call the kernel: scoring in f32 and in the bf16 r/k/v that
    # rwkv6_3b scoring runs, and the f32 serving prefill
    main_cases = [(SCORE_B, SCORE_S, H, n, None, "model", torch.float32,
                   False),
                  (SCORE_B, SCORE_S, H, n, None, "model", torch.bfloat16,
                   False),
                  (SERVE_B, PROMPT, H, n, None, "model", torch.float32,
                   False)]
    cases += main_cases
    # the decode step (T 1) and the double buffer's edges: T 2, and 2 x
    # chunk + 1 (the third tile refills the first buffer); the default tile
    # (None), strong decay, bf16
    cases += [(SERVE_B, T, H, n, chunk, decay, dt, False)
              for T, chunk in ((1, None), (2, None), (2 * 16 + 1, 16),
                               (2 * 32 + 1, 32), (2 * 3 + 1, 3))
              for decay, dt in ((mild, torch.float32),
                                (strong, torch.float32),
                                (mild, torch.bfloat16))]
    cases += [(1, 33, 2, nn_, 16, strong, torch.float32, False)
              for nn_ in (16, 32)]
    worst, worst_long, gated, y_err = 0.0, 0.0, 0.0, 0.0
    main_err, tiles = {}, {}
    rtol, atol = WKV_TOL
    sms = rk._build.sm_count(0)
    for case in cases:
        B, T, Hh, nn_, chunk, decay, dt, strided = case
        ins = inputs(B, T, Hh, nn_, decay, dt, strided)
        want = rk.wkv6_plain(*ins)
        before = rk.STATS.launches
        got = rk.wkv6(*ins, chunk=chunk)
        torch.cuda.synchronize()
        long_ = decay == "model" and T >= PROMPT
        tile = chunk or rk.auto_chunk(B, Hh, nn_, ins[0].element_size(), sms)
        label = (f"wkv6 B{B} T{T} H{Hh} n{nn_} chunk {chunk} (tile {tile}) "
                 f"decay {decay} {str(dt)[6:]} strided={strided}")
        check(rk.STATS.launches == before + 1, f"{label}: not one launch")
        check(torch.equal(got[1], want[1]), f"{label}: sT is not bit-equal "
              f"to the plain twin's (max abs err "
              f"{float((got[1] - want[1]).abs().max())})")
        g, w_ = got[0], want[0]
        diff = (g - w_).abs()
        strict = float((diff / (atol + rtol * w_.abs())).max())
        limit = WKV_LONG_ATOL if long_ else atol
        ratio = float((diff / (limit + rtol * w_.abs())).max())
        check(ratio <= 1 and bool(torch.isfinite(g).all()),
              f"{label}: y differs from the plain twin (max abs err "
              f"{float(diff.max())}, {ratio:.3g} x the limit)")
        gated = max(gated, ratio)
        if long_:
            worst_long = max(worst_long, strict)
        else:
            worst = max(worst, strict)
        y_err = max(y_err, float(diff.max()))
        if case in main_cases:
            main_err[case], tiles[case] = float(diff.max()), tile
        del got, ins, want
    sc32, sc16, pre = main_cases
    print(f"[10/13] wkv6 == plain on {len(cases)} shapes (JAX sweep, strong "
          f"decay U{strong}, T not whole chunks, strided, bf16 r/k/v, "
          f"{RWKV} scoring in f32 and bf16 at tiles {tiles[sc32]} and "
          f"{tiles[sc16]}, the serving prefill at tile {tiles[pre]}, the "
          f"decode step T 1, T 2 and T 2 x chunk + 1): sT bit-equal in "
          f"every case; max abs err y {y_err:.3g}; worst |got - want| / "
          f"({atol:g} + {rtol:g} |want|) {worst:.3g}, at T {PROMPT} and "
          f"{SCORE_S} {worst_long:.3g} (limit there {WKV_LONG_ATOL:g} + "
          f"{rtol:g} |want|, worst {gated:.3g} of it or of the sweep's)")

    ins = inputs(SCORE_B, SCORE_S, H, n, "model")
    ms = device_ms(lambda: rk.wkv6(*ins), 20)
    plain = time_ms(lambda: rk.wkv6_plain(*ins), 1)
    bound, by = wkv_bound_ms(SCORE_B, SCORE_S, H, n, torch.float32)
    del ins
    ins = inputs(SCORE_B, SCORE_S, H, n, "model", torch.bfloat16)
    bf16_ms = device_ms(lambda: rk.wkv6(*ins), 20)
    bf16_bound, _ = wkv_bound_ms(SCORE_B, SCORE_S, H, n, torch.bfloat16)
    del ins
    print(f"      wkv6 f32 [B{SCORE_B} T{SCORE_S} H{H} n{n}]: kernel "
          f"{ms:.4f} ms (tile {tiles[sc32]}), plain {plain:.1f} ms, bound "
          f"{bound:.4f} ms ({by}); bf16 r/k/v (the model's scoring) "
          f"{bf16_ms:.4f} ms (tile {tiles[sc16]}), bound {bf16_bound:.4f} "
          f"ms; no single PyTorch call computes it")
    ins = inputs(SERVE_B, PROMPT, H, n, "model")      # the serving prefill
    pre_ms = device_ms(lambda: rk.wkv6(*ins), 20)
    pre_bound, pre_by = wkv_bound_ms(SERVE_B, PROMPT, H, n, torch.float32)
    print(f"      wkv6 f32 [B{SERVE_B} T{PROMPT} H{H} n{n}] (serving "
          f"prefill): kernel {pre_ms:.4f} ms (tile {tiles[pre]}), bound "
          f"{pre_bound:.4f} ms ({pre_by})")
    del ins
    ins = inputs(SERVE_B, 1, H, n, "model")           # one decode step
    dec_ms = device_ms(lambda: rk.wkv6(*ins), 300)
    dec_host = min(host_us(lambda: rk.wkv6(*ins), 300) for _ in range(3))
    dec_plain = device_ms(lambda: rk.wkv6_plain(*ins), 100)
    dec_bound, dec_by = wkv_bound_ms(SERVE_B, 1, H, n, torch.float32)
    print(f"      wkv6 f32 [B{SERVE_B} T1 H{H} n{n}] (a decode step): kernel "
          f"{dec_ms * 1e3:.2f} us of device time, host path {dec_host:.2f} "
          f"us; plain twin (the old decode step on the card) "
          f"{dec_plain * 1e3:.2f} us of device time; bound "
          f"{dec_bound * 1e3:.2f} us ({dec_by})")
    del ins
    torch.cuda.empty_cache()
    return dict(max_abs_err=main_err[sc32], worst_err_ratio=gated,
                ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, bf16_ms=bf16_ms, bf16_bound_ms=bf16_bound,
                bf16_max_abs_err=main_err[sc16], prefill_ms=pre_ms,
                prefill_bound_ms=pre_bound, prefill_max_abs_err=main_err[pre],
                decode_ms=dec_ms, decode_bound_ms=dec_bound,
                decode_plain_ms=dec_plain, decode_host_us=dec_host)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import accel, cost_model as cm, gsampler as gs
    from repro_torch.core import infer, model as dtm
    from repro_torch.kernels import _build, fusion_eval as fe
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    from repro_torch.kernels import rwkv6_scan as rk
    from repro_torch.configs import get_config
    from repro_torch.workloads import CNN_ZOO
    from repro_torch.workloads.grid import paper_grid

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # -- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[1/13] device: {kind} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | devices "
          f"{torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    sources = (fe.SOURCE, fa.SOURCE, fd.SOURCE, rk.SOURCE)
    _build.build(*sources)
    fe.compiled_backend_supported()
    infos = {src: _build.build_info(src) for src in sources}
    print(f"[2/13] build: " + ", ".join(
        f"{src}.cu {infos[src]['build_s']:.2f} s" for src in sources) +
        f" (in parallel; cached={infos[fe.SOURCE]['cached']}), probe ok, "
        f"phase {time.perf_counter() - t0:.2f} s")
    for src in sources:
        print(f"      {src}.cu flags: {' '.join(_build.flags(src))}")
        for line in infos[src]["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "setmaxnreg",
                                       "warning")):
                print(f"      ptxas {src}: {line.strip()}")
    for hd in fa.HEAD_DIMS:
        info = fa.tc_info(hd)
        print(f"      flash_attention tensor-core kernel at hd {hd}: "
              f"{info['threads']} threads, setmaxnreg producer "
              f"{info['producer_regs']} / consumers {info['consumer_regs']} "
              f"registers, {info['stages']} K/V stages, "
              f"{info['smem_bytes']} bytes of shared memory")

    # -- conditions ---------------------------------------------------------
    parts = sorted(accel.ACCEL_ZOO)
    conds, workloads, batches, budgets = paper_grid(parts, BUDGETS_MB, BATCH)
    C = len(conds)
    hws = [accel.ACCEL_ZOO[p] for _, p, _ in conds]
    packed = cm.stack_workloads([cm.pack_workload(w, h, NMAX, device=dev)
                                 for w, h in zip(workloads, hws)])
    n_of = np.array([w.n for w in workloads])
    names = sorted(CNN_ZOO)
    wls = {n: CNN_ZOO[n]() for n in names}
    rng = np.random.default_rng(0)

    def population(n_rows, pop, nmax=NMAX):
        return torch.as_tensor(np.stack([
            np.stack([cm.random_strategy(rng, int(k), nmax, BATCH,
                                         p_sync=0.1 + 0.6 * (j % 5) / 4)
                      for j in range(pop)]) for k in n_rows]), device=dev)

    # -- 3. kernel against its plain version ---------------------------------
    edge_packed = cm.stack_workloads([
        cm.pack_workload(wls[n], accel.ACCEL_ZOO["edge"], NMAX, device=dev)
        for n in names for _ in parts])
    edge_hw = [accel.ACCEL_ZOO[p] for _ in names for p in parts]
    edge_n = [wls[n].n for n in names for _ in parts]
    edge_budgets = torch.tensor([BUDGETS_MB[i % len(BUDGETS_MB)] * MB
                                 for i in range(len(edge_n))], device=dev)
    batches_t = torch.as_tensor(batches, device=dev)
    budgets_t = torch.as_tensor(budgets, device=dev)
    hwv = accel.stack_hw(hws, C, dev)
    cases = [("zoo-served-edge-pack pop40", edge_packed, edge_hw, edge_n,
              edge_budgets, 40),
             ("zoo-served-edge-pack pop133", edge_packed, edge_hw, edge_n,
              edge_budgets, 133)] + [
        (f"main-path grid pop{pop}", packed, hwv, n_of, budgets_t, pop)
        for pop in FE_POPS]
    for nmax in (32, 19):               # one chunk; resnet18 at n = P - 1
        small = [n for n in names if wls[n].n < nmax]
        cases.append((f"small-nets-edge-pack nmax{nmax} pop40",
                      cm.stack_workloads([cm.pack_workload(
                          wls[n], accel.ACCEL_ZOO["edge"], nmax, device=dev)
                          for n in small for _ in parts]),
                      [accel.ACCEL_ZOO[p] for _ in small for p in parts],
                      [wls[n].n for n in small for _ in parts],
                      edge_budgets[:len(small) * len(parts)], 40))
    max_err = 0.0
    main_args = {}
    for label, wl_rows, hw_rows, n_rows, budg, pop in cases:
        strat = population(n_rows, pop, wl_rows["A"].shape[1])
        Cc, _, P = strat.shape
        args = fe.kernel_args(wl_rows, strat,
                              torch.full((Cc,), float(BATCH), device=dev),
                              hw_rows)
        mask = wl_rows["mask"][:, None, :].expand_as(strat)
        for form in fe.Form:
            got = fe.fusion_eval(form, args, budg)
            want = fe.fusion_eval_plain(form, *args, budg)
            torch.cuda.synchronize()
            for k in want[0]._fields:
                g, w = getattr(got[0], k), getattr(want[0], k)
                if g.is_floating_point():
                    max_err = max(max_err, float((g - w).abs().max()))
                check(torch.equal(g, w), f"{label} {form.name}: CostOut.{k} "
                      f"not bit-equal to the plain version")
            for j, (g, w) in enumerate(zip(got[1:], want[1:])):
                if g.dtype == torch.int32:
                    check(torch.equal(g[mask], w[mask]), f"{label} "
                          f"{form.name}: gid differs under the mask")
                    continue
                max_err = max(max_err, float((g - w).abs().max()))
                check(torch.equal(g, w), f"{label} {form.name}: group "
                      f"matrix {j} not bit-equal to the plain version")
        raw = fe.fusion_eval_raw(*args)
        check(all(torch.equal(g, w) for g, w in zip(raw[:6], want[1:7])),
              f"{label}: fusion_eval_raw differs from the raw form")
        print(f"[3/13] kernel == plain on {label} [{Cc}x{pop}x{P}], "
              f"forms cost, stats, raw: bit-equal, CostOut included")
        if label.startswith("main-path"):
            main_args[pop] = args
    live = int(n_of.sum())
    fe_ms = {}
    for pop in FE_POPS:
        for form in fe.Form:
            ms = device_ms(lambda: fe.fusion_eval(form, main_args[pop],
                                                  budgets_t), 200)
            bound, by, nbytes = fe_bound_ms(C, pop, NMAX, live, form)
            fe_ms[(form, pop)] = (ms, bound, by)
            print(f"      fusion_eval {form.name.lower()} form at "
                  f"[{C}x{pop}x{NMAX}]: {ms * 1e3:.3f} us of device time, "
                  f"bound {bound * 1e3:.3f} us ({by}, {nbytes} bytes), "
                  f"{bound / ms:.3f} of it; tile "
                  f"{fe.tile_for(C, pop, NMAX, _build.sm_count(0))}")
    s36, s40 = main_args[36][0], main_args[40][0]
    grid40 = lambda: cm.evaluate_grid(packed, s40, batches_t, budgets_t, hwv)
    stats36 = lambda: cm.evaluate_grid_stats(packed, s36, batches_t,
                                             budgets_t, hwv)
    fe_host = {
        "evaluate_grid pop40": host_us(grid40, 300),
        "evaluate_grid_stats pop36": host_us(stats36, 300),
        "evaluate_grid pop40, check uncached": host_us(
            lambda: (fe._CHECKED.clear(), grid40()), 300),
        "evaluate_grid_stats pop36, check uncached": host_us(
            lambda: (fe._CHECKED.clear(), stats36()), 300)}
    fe_plain = time_ms(lambda: fe.fusion_eval_plain(
        fe.Form.STATS, *main_args[36], budgets_t), 5)
    print(f"      fusion_eval host us a call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in fe_host.items()) +
        f"; plain twin, stats form at [{C}x36x{NMAX}]: {fe_plain:.3f} ms")

    # -- 4. G-Sampler on the card -------------------------------------------
    cfg = gs.GSamplerConfig()
    fe.reset_launches()
    t0 = time.perf_counter()
    res = gs.gsampler_search_grid(workloads, hws,
                                  batches, budgets, nmax=NMAX, cfg=cfg,
                                  top_k=4, packed=packed, device=dev)
    gs_wall = time.perf_counter() - t0
    gs_launches = fe.STATS.launches
    want_launches = 18 + cfg.generations * (1 + cfg.repair_tries) + 1
    check(gs_launches == want_launches,
          f"G-Sampler launched fusion_eval {gs_launches} times, expected "
          f"{want_launches}")
    best = np.where(res.valid, res.speedup, 0.0).max(1)
    check(np.isfinite(res.latency).all() and res.strategies.shape ==
          (C, 4, NMAX), "G-Sampler result malformed")
    check(res.valid[:, 0].mean() > 0.5, "G-Sampler found too few valid "
          "strategies")
    print(f"[4/13] G-Sampler pop {cfg.population} x {cfg.generations} gens "
          f"over {C} conditions: wall {gs_wall:.3f} s, fusion_eval launches "
          f"{gs_launches}, mean best speedup {best.mean():.4f}, valid share "
          f"{res.valid[:, 0].mean():.4f}")

    # -- 5. DT one shot on the card -----------------------------------------
    model = dtm.dt_init(dtm.DTConfig(hw_dim=accel.HW_FEATURE_DIM), seed=0,
                        device=dev)
    infer.dnnfuser_infer_batch(model, packed, batches, budgets, hws,
                               device=dev)             # warm-up
    torch.cuda.synchronize()
    fe.reset_launches()
    t0 = time.perf_counter()
    out = infer.dnnfuser_infer_batch(model, packed, batches, budgets, hws,
                                     device=dev)
    torch.cuda.synchronize()
    dt_wall = time.perf_counter() - t0
    re = cm.evaluate_grid(packed, out["strategy"][:, None, :], batches,
                          budgets, hws)
    torch.cuda.synchronize()
    dt_launches = fe.STATS.launches
    check(dt_launches == 1, f"re-score launched fusion_eval {dt_launches} "
          f"times, expected 1")
    strat = out["strategy"].cpu().numpy()
    check(((strat[:, 0] >= 1) & (strat[:, 0] <= BATCH)).all(),
          "DT input micro-batch out of range")
    for k in ("latency", "peak_mem", "traffic"):
        a = getattr(re, k)[:, 0].cpu().numpy()
        b = out[k].cpu().numpy()
        check(np.isfinite(b).all(), f"DT {k} not finite")
        check(np.allclose(a, b, rtol=1e-5, atol=0),
              f"DT {k} differs from the kernel re-score "
              f"(max rel {np.max(np.abs(a - b) / np.abs(b))})")
    check(torch.equal(re.valid[:, 0], out["valid"]), "DT valid differs")
    check(torch.equal(re.n_groups[:, 0], out["n_groups"]),
          "DT n_groups differs")
    dt_valid = out["valid"].float().mean().item()
    dt_speed = out["speedup"][out["valid"]].mean().item() if dt_valid else 0.0
    print(f"[5/13] DT one shot (3x2x128, hw_dim 10, seeded random weights) "
          f"over {C} conditions: wall {dt_wall:.4f} s, valid share "
          f"{dt_valid:.4f}, mean valid speedup {dt_speed:.4f}; re-score "
          f"matches (rtol 1e-5); G-Sampler/DT wall ratio "
          f"{gs_wall / dt_wall:.1f} (informative)")

    # -- 6.-9. the dense LM: kernels, scoring, serving, self-check ---------
    L = get_config(ARCH).n_layers
    attn = attention_kernels(dev)
    torch.cuda.empty_cache()
    fa_launches = scoring(dev, ARCH, 7, flash_attention=L,
                          fa_tensor_core=L)["flash_attention"]
    served = serving(dev, ARCH, 8, flash_decode=L * (GEN - 1))
    self_check(dev, ARCH, served, 9,
               want_fwd={"flash_attention": L, "fa_cuda_core": L})
    fd_launches = served["launches"]["flash_decode"]
    del served                          # qwen3_8b is gone before rwkv6_3b

    # -- 10.-13. the RWKV6 LM: kernel, scoring, serving, self-check ---------
    L = get_config(RWKV).n_layers
    wkv = wkv_kernel(dev)
    wkv_launches = scoring(dev, RWKV, 11, wkv6=L)["wkv6"]
    served = serving(dev, RWKV, 12, wkv6=L + L * (GEN - 1))
    self_check(dev, RWKV, served, 13, want_fwd={"wkv6": L},
               want_prefill={"wkv6": L}, want_step={"wkv6": L})
    wkv_served = served["launches"]["wkv6"]
    del served
    print(f"      total {time.perf_counter() - t_all:.1f} s")

    print(smi)
    csrc = "src/repro_torch/kernels/csrc"
    print(json.dumps({"kernels": [
        {"name": "fusion_eval", "route": "cuda",
         "source": f"{csrc}/fusion_eval.cu",
         "replaces": "src/repro/kernels/fusion_eval.py:57",
         "launches": gs_launches + dt_launches, "max_abs_err": max_err,
         "ms": fe_ms[(fe.Form.STATS, 36)][0], "plain_ms": fe_plain,
         "bound_ms": fe_ms[(fe.Form.STATS, 36)][1],
         "bound_by": fe_ms[(fe.Form.STATS, 36)][2], "library_ms": None,
         "form": "stats", "shape": [C, 36, NMAX],
         "forms": {f"{f.name.lower()} pop{p}": {"ms": v[0], "bound_ms": v[1]}
                   for (f, p), v in fe_ms.items()},
         "host_us": fe_host},
        {"name": "flash_attention", "route": "cuda",
         "source": f"{csrc}/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:27",
         "launches": fa_launches, **attn["flash_attention"]},
        {"name": "flash_decode", "route": "cuda",
         "source": f"{csrc}/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:24",
         "launches": fd_launches, **attn["flash_decode"]},
        {"name": "wkv6", "route": "cuda", "source": f"{csrc}/wkv6.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:26",
         "launches": wkv_launches + wkv_served, **wkv}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
