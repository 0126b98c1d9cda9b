#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--parent-fa TREE]

With ``--parent-fa``, ``TREE``'s ``flash_attention.cu`` (a checkout of an
earlier commit) is built beside this one's and its f32 kernel is timed in
turns with this one in phases 8 and 11.

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
6. the paper loop on the card: ``generate_teacher_corpus`` over the same
   grid (the paper's GA, top 8 elites and 2 jittered copies of the top 4
   per condition, decorated by one ``prefix_scan``) in exactly 369
   ``fusion_eval`` launches, its decoration's final costs equal to the
   kernel's re-score of the same candidates (rtol 1e-5, ``valid`` and
   ``n_groups`` equal) and its rows equal to a replay's; ``train_model``
   of the full-width hw-conditioned DT on that corpus (the reference's
   TrainConfig, 3000 steps), its loss curve falling, and 20 steps run
   twice from one seed and once with a crash at step 10 and a resume,
   bit-identical parameters all three times; then the trained DT answers
   the 120 conditions (re-scored as in phase 5, beside the G-Sampler's and
   the untrained DT's numbers), the same nets and parts at budgets the
   corpus never saw (12, 24, 48 MB, beside a G-Sampler search of them),
   and on a few conditions the host ``dnnfuser_infer`` is compared with
   the fused episode;
7. serving on the card, with phase 6's trained DT: ``repro_torch.serve``
   warmed over the 6 CNNs on the default ``ServingConfig``, then a seeded
   stream of 480 requests in bursts of 16-64 (6 CNNs x 5 parts x budgets
   8..64 MB x batch 16/64) through the async scheduler: no new signature
   after warmup, repeats answered from the cache, every strategy equal to
   ``dnnfuser_infer_batch``'s and every cost to a ``fusion_eval``
   re-score (rtol 1e-5); 32 of the requests served alone by fresh engines
   and a permuted replay, bit-identical; the strategy cache saved and
   loaded by a fresh engine, which answers the stream with no episode
   call; an engine with ``polish=True, escalate=True`` over the smoke grid
   plus budgets 0.25-1 MB (at least 8 one-shot answers over budget),
   never worse by the teacher's fitness (both re-scored by
   ``fusion_eval``), ``fusion_eval`` launched, a second engine's answers
   to every third condition bit-identical; the drift monitor fired by
   the stream's undeclared
   parts, a ``RefreshWorker.poll()`` (corpus, fine-tune, gate) and, on
   accept, a swap with no new signature and the edge entries bit-exact;
   req/s, p50/p99 latency, episode calls, hit rate, walls and launches;
8. attention kernels against their plain versions: ``flash_attention`` at
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
   the old limit; f32 ``flash_attention`` (the 3xTF32 tensor-core path)
   called twice a case, one launch a call and bit-identical, and at q, k
   x 4 and x 8 (at the self-check's shape and a small one) within twice
   the plain twin's error against an f64 attention; then each is timed
   against its plain version and one ``scaled_dot_product_attention``
   call, ``flash_attention`` on both paths (bf16 at the scoring shape, f32
   at the self-check's and the scoring shape, beside its 3xTF32 bound and
   the CUDA cores' 67 TFLOP/s one),
   ``flash_decode`` by its device time a call (``device_ms``) and, apart,
   its wrapper's host time a call (``host_us``), also at qwen3_moe's
   decode shape (G 16: 64 q-heads over 4 kv-heads); the new families'
   shapes are among the cases: ``flash_attention`` non-causal at S 1 and
   187 over T 1500 (whisper's cross-attention) and at 25/5 heads with a
   1024 window (hymba), ``flash_decode`` at G 16, 5 and 6, kv_len 1 to T,
   and at G 16's largest split (bk 2048);
9. scoring: qwen3_8b at full width and depth (bf16, seeded random
   weights) scores 2 x 4096 tokens through ``lm.forward``: exactly 36
   ``flash_attention`` launches, all on the tensor-core path, finite
   logits;
10. serving: ``serve_greedy("qwen3_8b", batch=4, prompt_len=1024,
   gen_len=128)`` in f32: prefill (chunked, no kernel), then 127 greedy
   decode steps, exactly 36 x 127 ``flash_decode`` launches;
11. full-width self-check: an f32 ``forward`` over the prompt and the
   generated tokens (36 ``flash_attention`` launches, all on the 3xTF32
   tensor-core path; its wall timed) reproduces the served logits (within
   1e-3 of the logits' largest magnitude) and the greedy tokens
   (near-ties counted);
12. ``wkv6`` against ``wkv6_plain``, the sequential recurrence, in f32 at
   the JAX sweep's shapes, under strong decay, at a T that is not a whole
   number of chunks, on strided inputs, at the main path's shapes with
   the default tile (rwkv6_3b's scoring shape in f32 and in bf16 r/k/v,
   the serving prefill's, the decode step T 1) and at the double buffer's
   edges (T 2, 2 x chunk + 1): y within 5e-5 + 5e-5 |plain| (the sweep's;
   see ``WKV_LONG_ATOL`` for the 1024- and 4096-step shapes), sT
   bit-equal in every case; then timed against its plain version at the
   scoring shape (f32 and bf16), the serving prefill's and a decode
   step's (device and host time);
13. scoring: rwkv6_3b at full width and depth (bf16, seeded random
   weights) scores 2 x 4096 tokens through ``rwkv_lm.forward``: exactly
   32 ``wkv6`` launches, finite logits;
14. serving: ``serve_greedy("rwkv6_3b", batch=4, prompt_len=1024,
   gen_len=128)`` in f32: exactly 32 + 32 x 127 = 4096 ``wkv6`` launches,
   32 in the prefill and one per layer in each decode step;
15. RWKV self-check: an f32 ``forward`` through ``wkv6`` over the prompt
   and the generated tokens reproduces the served logits and greedy
   tokens as in phase 11, and one prefill and one decode step each launch
   ``wkv6`` once per layer;
16. the paper's Table 1 and the exact optimum on the card, through
   ``fusion_eval``: on VGG16 (the reference's two cases, 20 MB at batch
   64 and 40 MB at batch 128, nmax 20) the six black-box baselines at
   2000 samples, each equal to the same run on the CPU and launching the
   kernel exactly 51 times (50 generations and the best), A2C (150
   episodes; two short runs of one seed equal), the host G-Sampler, and
   a DT and an S2S trained 400 steps on the host teacher's corpus over
   16-64 MB answering one shot (two 20-step S2S trainings of one seed
   bit-identical; the S2S's answers equal a ``fusion_eval`` re-score and
   are bit-identical alone and batched); a row per method and case
   (speedup or N/A, usage, wall); then ``optimal_grid`` over tiny_cnn x
   {edge, nano, datacenter} x {2, 6} MB (less datacenter at 2 MB),
   certified in one launch, each cell's ``optimal_mapping`` the same in
   one launch, the G-Sampler never below the optimum, the optimal-teacher
   corpus equal to a replay whose elites are the DP's optima, and phase
   6's trained DT's gap to the optimum (informative);
17. qwen3_moe_235b at full width (d 4096, 64/4 heads, 128 experts top-8),
   4 of 94 layers: bf16 scoring 2 x 4096 (exactly 4 tensor-core
   ``flash_attention`` launches, finite logits and aux loss, a second run
   bit-identical); ``serve_greedy`` f32, batch 4, prompt 1024, 32 tokens
   (exactly 4 x 31 ``flash_decode`` at G 16); a self-check: an f32
   forward over the prompt reproduces the prefill's row, and a serve at
   ``impl="dense"`` (same routing groups) the 32 served rows and tokens
   (a forward over prompt and generated tokens routes them as one group,
   whose capacity keeps other tokens, so it is no oracle for MoE);
18. grok1_314b at full width (d 6144, 48/8 heads, 8 experts top-2), 2 of
   64 layers: bf16 scoring 2 x 4096 (2 ``flash_attention``), the
   experts' loads and dropped share a layer;
19. qwen2_vl_72b at full width (d 8192, 64/8 heads, M-RoPE (16, 24, 24)),
   4 of 80 layers, on embeddings: bf16 scoring 2 x 4096 with a 32 x 32
   image grid in ``pos_thw`` (4 ``flash_attention``); serving f32
   (prompt 1024 embeddings, a zero embedding a step: 4 x 31
   ``flash_decode``); a self-check by an f32 forward over the replay;
20. hymba_15b whole (32 layers, 25/5 heads, SSM state 16): bf16 scoring
   2 x 2048 (32 ``flash_attention``, 30 at window 1024) and the SSM scan
   loop's share of a forward's wall; serving f32 (2 x 31 ``flash_decode``:
   only the two full-attention layers); a self-check;
21. whisper_base whole (6 + 6 layers): ``serve_greedy`` f32 over 1500
   frames and a 187-token decoder prompt, 32 tokens (encoder 6, the
   prefill's cross-attention 6 and each step's 6 ``flash_attention`` at
   S 1, and 6 ``flash_decode`` a step); a self-check; then the LM
   mapping: the ten archs' prefill chains (``lm_workload``, seq 4096,
   batch 32) searched by the host G-Sampler at 48 MB, nmax 128 through
   ``fusion_eval``, each equal to the same search on the CPU (run in
   worker processes beside the card's work).  Phases 17-21 free each
   model before the next;
22. LM training: gemma3_1b at full width (1.0e9 parameters, f32, seeded
   random weights, batch 8 x 128 as ``launch.train``'s defaults): the
   mapper's micro-batch under 24 MB (the host G-Sampler on
   ``fusion_eval``, equal to the same search on the CPU), then 8 steps of
   ``make_local_train_step`` at its ``grad_accum``: ms a step against
   its f32 FLOP bound, tokens/s, peak memory, the losses (the last below
   the first), every first-step gradient finite and not all zero, no
   attention or WKV kernel launched; ``train`` at reduced size straight
   through and crashed at step 10 and restarted, parameters and moments
   bit-identical; one reduced ``train(use_mapper=True)`` step each for
   rwkv6_3b, qwen3_moe_235b, hymba_15b, whisper_base and qwen2_vl_72b,
   the default ``loss_fn``'s gradients ``impl="dense"``'s bit for bit;
23. the distributed half, on a one-rank NCCL group (a ``HashStore``, no
   TCP port) destroyed at the end: the transfer path on
   ``data_parallel_mesh()`` (the VGG16/ResNet18 grid corpus, its
   ``fusion_eval`` launches equal to the CPU's evaluations; 300
   data-parallel DT steps and ``fine_tune(mesh=)`` on MnasNet, both
   bit-equal to ``mesh=None``); ``MapperEngine`` with every visible card
   as replicas on phase 7's requests, bit-identical to no replicas;
   ``build_train_step`` at gemma3_1b full width (FSDP2 over 'data')
   against ``make_local_train_step``, ms a step and peak; the dry-run's
   argument bytes and FLOPs equal to that real step's, its predicted peak
   beside the card's; ``build_prefill`` + ``build_decode_step`` at
   qwen3_8b full width serving phase 10's tokens;
24. the LMs on a (data 1, model 2) mesh, two rank processes
   (``tp_route``: NCCL with a card each where there are two, else gloo
   with both on the one card, CUDA tensors), each model built as the
   rank's shard of the seed-0 draw: qwen3_8b serving (the cache's
   positions over the ranks, each step's ``flash_decode`` over the
   rank's keys with its statistics, merged; phase 10's tokens and
   36 x 7 launches a rank), qwen3_8b bf16 scoring at the rank's heads
   (36 ``flash_attention`` a rank; logits against phase 9's; witnesses:
   the same weights in f32 against phase 9's f32 forward, and a control
   whose 'model' sums are coarser, which the bf16 limit must reject),
   rwkv6_3b serving at 20 heads a rank (phase 14's tokens), qwen3_moe
   (4 layers) scoring with the experts over 'model' (phase 17's f32
   routing, every kept and dropped (token, expert) pair, and logits; in
   bf16 its routing against phase 17's bf16 scoring's, with the router's
   top-k margin of each token whose experts differ), gemma3_1b training
   against phase 23's local step (losses
   within 1e-5); walls, peaks and the bytes each part's collectives
   moved.  Phase 8 also holds ``flash_decode``'s statistics (the output
   with them bit-equal to the one-shot call's) and the merge of 2, 4
   and 16 key shards to the unsharded call at G 1, 4, 5, 8 and 16, and
   the ranks' attention and ``wkv6`` shapes.
25. bf16 training of the mixed-type LMs, on a one-rank NCCL group:
   ``build_train_step`` at its default bf16 for hymba_15b at full width
   (1.5e9 parameters; its SSM's ``A_log`` and ``D`` stay f32), reduced
   qwen3_moe_235b (the f32 router) and reduced rwkv6_3b (``w0``, ``u``)
   against ``make_local_train_step`` in bf16: leaf types kept, every f32
   leaf moved, losses within 2e-3; then ``remat`` "none", "full" and
   "dots" in turns at phase 23's gemma3_1b full-width f32 cell: the first
   step's loss and gradients under "dots" bit-equal to "none"'s, the
   bytes each policy's forward keeps for the backward ordered full <
   dots < none, the losses of every turn equal; ms a step and peak GiB
   of each.

The last lines are the card's ``nvidia-smi`` name and power limit, a JSON
line with each kernel's launches, error and times, and
``{"ok": true, "device": {...}}``.  It imports nothing of JAX and nothing
of the JAX package, and exits non-zero without output when no CUDA device
is present or the port's sources are not beside it.
"""
from __future__ import annotations

import contextlib
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
H100_TF32_OPS_PER_S = 495e12    # TF32 on the tensor cores, dense
TF32X3_PRODUCTS = 3             # TF32 products per f32 one (3xTF32)
FE_OPS_PER_POSITION = 48        # f32 operations of one live (candidate, pos)
FE_POPS = (1, 36, 40)           # the naive search and re-score, repair, GA
MB = 2.0 ** 20
ARCH = "qwen3_8b"
RWKV = "rwkv6_3b"
MOE, GROK, VLM = "qwen3_moe_235b", "grok1_314b", "qwen2_vl_72b"
HYMBA, WHISPER = "hymba_15b", "whisper_base"
# layers kept of the configs one card cannot hold whole (80 GB): bf16
# scoring needs 22.4 GB (4 of 94 qwen3_moe layers), 22.9 GB (2 of 64 grok1
# layers) and 12 GB (4 of 80 qwen2_vl layers); f32 serving twice that
DEPTH = {MOE: 4, GROK: 2, VLM: 4}
NEW_GEN = 32                    # tokens served by phases 17-21
HYMBA_S = 2048                  # hymba's scoring length (its window 1024)
WHISPER_T = 1500                # 30 s of audio: the encoder's frames
WHISPER_DEC = WHISPER_T // 8    # the decoder's prompt (187)
MAP_BUDGET_MB, MAP_NMAX = 48.0, 128     # benchmarks/lm_mapping.py's
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
    visible (query, key) pair and head over the peak of the input type
    (for f32 the CUDA cores' 67 TFLOP/s, kept as a reference line beside
    the f32 route's own bound, ``fa_tf32x3_bound_ms``); q, k, v read once
    and the output written once over HBM."""
    import torch
    size = torch.finfo(dtype).bits // 8
    ops = 4 * hd * visible_pairs(S, T, causal, window) * B * Hq
    nbytes = size * (2 * B * S * Hq * hd + 2 * B * T * Hkv * hd)
    return roofline_ms(nbytes, ops, peak_ops(dtype))


def fa_tf32x3_bound_ms(B, S, T, Hq, Hkv, hd, causal, window):
    """Least time for one f32 flash_attention call on its route: each f32
    operation is TF32X3_PRODUCTS TF32 ones, over the TF32 tensor-core
    peak; f32 q, k, v read once and the output written once over HBM."""
    ops = TF32X3_PRODUCTS * 4 * hd * visible_pairs(S, T, causal, window) \
        * B * Hq
    nbytes = 4 * (2 * B * S * Hq * hd + 2 * B * T * Hkv * hd)
    return roofline_ms(nbytes, ops, H100_TF32_OPS_PER_S)


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


def family_attention_shapes():
    """The shapes at which phases 9-11 and 17-21 launch the attention
    kernels, from the configs: ``flash_attention`` cases (B, S, T, Hq, Hkv,
    hd, dtype, causal, window) and ``flash_decode`` groups (B, T, Hq, Hkv,
    hd, dtype, the served kv_lens), decode under the card's plan."""
    import torch
    from repro_torch.configs import get_config
    f32, bf16 = torch.float32, torch.bfloat16
    fa_cases, fd_groups = [], []
    for arch in (ARCH, MOE, GROK, VLM, HYMBA):
        cfg = get_config(arch)
        h = (cfg.n_heads, cfg.kv_heads, cfg.hd)
        S = HYMBA_S if arch == HYMBA else SCORE_S
        gen = GEN if arch == ARCH else NEW_GEN
        # the self-check's forward: the replayed prompt and tokens (a MoE
        # config's replays the prompt alone), none for grok1 (not served)
        fwd = {ARCH: PROMPT + GEN - 1, MOE: PROMPT, GROK: None}.get(
            arch, PROMPT + NEW_GEN - 1)
        for w in sorted({w if w > 0 else -1 for w in cfg.windows()}):
            fa_cases += [(SCORE_B, n, n, *h, bf16, True, w)   # warm-up, scoring
                         for n in (128, S)]
            if fwd:
                fa_cases.append((SERVE_B, fwd, fwd, *h, f32, True, w))
        if arch != GROK:
            fd_groups.append((SERVE_B, PROMPT + gen + 8, *h, f32,
                              range(PROMPT + 1, PROMPT + gen)))
    cfg = get_config(WHISPER)
    h = (cfg.n_heads, cfg.kv_heads, cfg.hd)
    fwd = WHISPER_DEC + NEW_GEN - 1
    fa_cases += [(SERVE_B, WHISPER_T, WHISPER_T, *h, f32, False, -1),  # encoder
                 (SERVE_B, fwd, fwd, *h, f32, True, -1)]    # decoder, replayed
    fa_cases += [(SERVE_B, S, WHISPER_T, *h, f32, False, -1)   # cross-attention
                 for S in (1, WHISPER_DEC, fwd)]
    fd_groups.append((SERVE_B, WHISPER_DEC + NEW_GEN + 8, *h, f32,
                      range(WHISPER_DEC + 1, WHISPER_DEC + NEW_GEN)))
    # phase 9's f32 witness (qwen3_8b scoring in f32); phase 24's ranks:
    # qwen3_8b's heads a rank scoring in bf16 and in f32 (and the warm-up),
    # qwen3_moe's in its f32 forward and its bf16 scoring, and qwen3_8b's
    # decode over a rank's TP-th of the cache, all q-heads: rank 0's keys
    # all seen, the last rank's PROMPT + 1 .. PROMPT + DIST_DECODE - 1 less
    # the shards before it
    cfg = get_config(ARCH)
    fa_cases.append((SCORE_B, SCORE_S, SCORE_S, cfg.n_heads, cfg.kv_heads,
                     cfg.hd, f32, True, -1))
    for arch in (ARCH, MOE):
        cfg = get_config(arch)
        h = (cfg.n_heads // TP, cfg.kv_heads // TP, cfg.hd)
        fa_cases += [(SCORE_B, n, n, *h, t, True, -1) for n in (128, SCORE_S)
                     for t in ((bf16, f32) if arch == ARCH else (bf16,))]
    fa_cases.append((SERVE_B, PROMPT, PROMPT, *h, f32, True, -1))
    cfg = get_config(ARCH)
    Tl = (PROMPT + GEN + 8) // TP
    fd_groups.append((SERVE_B, Tl, cfg.n_heads, cfg.kv_heads, cfg.hd, f32,
                      sorted({Tl} | {kl - (TP - 1) * Tl for kl in range(
                          PROMPT + 1, PROMPT + DIST_DECODE)})))
    return fa_cases, fd_groups


# attention-kernel shapes: those phase 8 held against the plain versions,
# and those the main path launched after it (every one must be held)
HELD, USED = set(), set()


def fa_shape(q, k, causal, window) -> tuple:
    B, S, Hq, hd = q.shape
    return ("flash_attention", str(q.dtype)[6:], B, S, k.shape[1], Hq,
            k.shape[2], hd, bool(causal), int(window))


def fd_shape(q, k, kv_len, bk) -> tuple:
    from repro_torch.kernels import flash_decode as fd
    return ("flash_decode", str(q.dtype)[6:], q.shape[0], k.shape[1],
            q.shape[2], k.shape[2], q.shape[3], int(kv_len),
            fd.plan(q, k, kv_len, bk))


def record_main_path_shapes() -> None:
    """From here on each launch of an attention kernel adds its shape to
    USED (the wrappers' ``_launch``, wrapped; the counts are unchanged)."""
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    fa_launch, fd_launch = fa._launch, fd._launch

    def fa_logged(q, k, v, causal, window):
        USED.add(fa_shape(q, k, causal, window))
        return fa_launch(q, k, v, causal, window)

    def fd_logged(q, k, v, kv_len, bk, stats):
        USED.add(fd_shape(q, k, kv_len, bk))
        return fd_launch(q, k, v, kv_len, bk, stats)

    fa._launch, fd._launch = fa_logged, fd_logged


def attention_kernels(dev, parent=None) -> dict:
    """Phase 8: both attention kernels against their plain versions, then
    timed at the main path's shapes, the f32 ``flash_attention`` in turns
    with ``parent``'s (an ``ab_flash_attention.finish_build`` library)
    where given.
    Returns the JSON fields."""
    import numpy as np
    import torch
    from repro_torch import ab_flash_attention as ab
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
    # the new families: whisper's cross-attention (a decode step's S 1 and
    # the prefill's S 187 over 1500 frames, non-causal), hymba's windowed
    # layers (25/5 heads, window 1024)
    new_fa = [(SERVE_B, S, WHISPER_T, 8, 8, 64, dt, False, -1)
              for S in (1, WHISPER_DEC)
              for dt in (torch.float32, torch.bfloat16)]
    new_fa += [(2, HYMBA_S, HYMBA_S, 25, 5, 64, dt, True, 1024)
               for dt in (torch.float32, torch.bfloat16)]
    # the wide GQA heads (qwen3_moe 64/4, grok1 48/8, qwen2_vl 64/8) in f32
    # at the scoring length, beside the main path's shapes below
    new_fa += [(1, SCORE_S, SCORE_S, Hq, Hkv, 128, torch.float32, True, -1)
               for Hq, Hkv in ((64, 4), (48, 8), (64, 8))]
    # every shape at which phases 9-11 and 17-21 launch the kernels
    fam_fa, fam_fd = family_attention_shapes()
    new_fa += [c for c in fam_fa if c not in fa_cases + new_fa]
    fa_cases += new_fa
    fa_err, fa_same = {}, 0
    for B, S, T, Hq, Hkv, hd, dt, c, w in fa_cases:
        q, k, v = qkv(dt, B, S, T, Hq, Hkv, hd)
        label = (f"flash_attention B{B} S{S} T{T} Hq{Hq}/{Hkv} hd{hd} "
                 f"{str(dt)[6:]} causal={c} window={w}")
        want = fa.flash_attention_plain(q, k, v, causal=c, window=w)
        limit = None
        if dt == torch.bfloat16:
            limit = fa.bf16_limit(q, k, v, causal=c, window=w, want=want)
        before = fa.STATS.launches
        got = fa.flash_attention(q, k, v, causal=c, window=w)
        if dt == torch.float32:          # the 3xTF32 path: deterministic
            again = fa.flash_attention(q, k, v, causal=c, window=w)
            torch.cuda.synchronize()
            check(fa.STATS.launches == before + 2, f"{label}: a call is not "
                  f"one launch")
            check(torch.equal(got, again), f"{label}: two calls differ")
            fa_same += 1
        err, strict, ratio = held(label, got, want, dt, limit)
        HELD.add(fa_shape(q, k, c, w))
        if limit is not None:
            fa_strict, fa_gated = max(fa_strict, strict), max(fa_gated, ratio)
        fa_err[dt] = max(fa_err.get(dt, 0.0), err)
        del q, k, v, want, limit, got
    # large scores (q, k x 4 and x 8): no f32 kernel holds the gate against
    # the twin there, so both are held to an f64 attention, the kernel's
    # error at most twice the twin's
    big = {}
    for B, S, Hq, Hkv, hd, c in ((SERVE_B, PROMPT + GEN - 1, 32, 8, 128, True),
                                 (1, 300, 4, 4, 64, False)):
        for scale in (4.0, 8.0):
            q, k, v = qkv(torch.float32, B, S, S, Hq, Hkv, hd)
            q, k = q * scale, k * scale
            exact = ab.attention_f64(q, k, v, c)
            got = float((fa.flash_attention(q, k, v, causal=c).double()
                         - exact).abs().max())
            twin = float((fa.flash_attention_plain(q, k, v, causal=c)
                          .double() - exact).abs().max())
            check(0 < got <= 2 * twin, f"flash_attention f32 B{B} S{S} "
                  f"Hq{Hq}/{Hkv} hd{hd} x{scale:g}: error against f64 {got} "
                  f"is over twice the plain twin's {twin}")
            big[f"B{B} S{S} hd{hd} x{scale:g}"] = (got, twin)
            del q, k, v, exact
        torch.cuda.empty_cache()
    print(f"[8/25] flash_attention == plain on {len(fa_cases)} shapes (JAX "
          f"sweep x f32/bf16 x causal/non-causal/window 96, one tile of 64 "
          f"and 128 rows at hd 64 and 128, GQA 4:1 and 8:1, ragged S/T "
          f"77/150, qwen3_8b heads at S {SCORE_S} and at ragged S "
          f"{PROMPT + GEN - 1}): max abs err f32 {fa_err[torch.float32]:.3g}"
          f", bf16 {fa_err[torch.bfloat16]:.3g}; bf16 (tensor-core path) "
          f"worst |got - want| / limit {fa_gated:.3g} against 1e-3 + 8e-3 "
          f"|plain| + 2^-8 plain(q, k, |v|), {fa_strict:.3g} against the "
          f"old 1e-3 + 8e-3 |plain|; f32 (3xTF32 path) two calls "
          f"bit-identical on all {fa_same}, one launch a call")
    print("      flash_attention f32 at large scores, max abs err against "
          "f64, kernel / twin: " + "; ".join(
              f"{key} {g:.3g} / {t:.3g} ({g / t:.3f})"
              for key, (g, t) in big.items()) + " (limit 2)")

    T_srv = PROMPT + GEN + 8
    fd_cases = [(B, T, Hq, Hkv, hd, kl, 256, dt, False)
                for B, T, Hq, Hkv, hd, kl in ((1, 1024, 4, 4, 64, 800),
                                              (2, 2048, 8, 2, 64, 2048),
                                              (1, 1024, 8, 1, 128, 513))
                for dt in (torch.float32, torch.bfloat16)]
    fd_cases += [(1, 72, 4, 2, 64, kl, bk, torch.float32, False)
                 for kl, bk in ((72, 512), (50, 32), (7, 16))]
    # the card's plan (bk None) at every kv_len a served family decodes
    # (qwen3_8b's 127 steps, 31 of each new family's)
    fd_cases += [(B, T, Hq, Hkv, hd, kl, None, dt, False)
                 for B, T, Hq, Hkv, hd, dt, kls in fam_fd for kl in kls]
    fd_cases += [(SERVE_B, T_srv, 32, 8, 128, kl, bk, dt, False)
                 for kl, bk in ((PROMPT + 1, None), (PROMPT + GEN - 1, None),
                                (1, None), (T_srv, None), (64, None),
                                (PROMPT + 40, 100), (T_srv, 512))
                 for dt in (torch.float32, torch.bfloat16)]
    fd_cases += [(SERVE_B, T_srv, 32, 8, 128, PROMPT // 2 + 1, bk,
                  torch.float32, True) for bk in (256, None)]
    # the new families' decode heads: G 16 (qwen3_moe, the 16-head build),
    # 5 (hymba) and 6 (grok1), kv_len 1 to T under the card's plan
    new_fd = [(SERVE_B, T_srv, Hq, Hkv, hd, kl, None, dt, False)
              for Hq, Hkv, hd in ((64, 4, 128), (25, 5, 64), (48, 8, 128))
              for kl in (1, PROMPT + 1, PROMPT + NEW_GEN - 1, T_srv)
              for dt in (torch.float32, torch.bfloat16)]
    fd_cases += new_fd + [(SERVE_B, 2100, 64, 4, 128, 2100, 2048,
                           torch.float32, False)]    # G 16's largest split
    fd_err, fd_plans, fd_same, made = {}, set(), 0, {}
    for B, T, Hq, Hkv, hd, kl, bk, dt, poison in fd_cases:
        shape = (dt, B, 1, T, Hq, Hkv, hd)
        if shape not in made:            # one draw for a run of one shape
            made = {shape: qkv(*shape)}
        q, k, v = made[shape]
        if poison:
            k, v = k.clone(), v.clone()
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
        HELD.add(fd_shape(q, k, kl, bk))
        fd_err[dt] = max(fd_err.get(dt, 0.0), err)
    del made, q, k, v
    served = sum(len(g[-1]) for g in fam_fd)
    print(f"      flash_decode == plain on {len(fd_cases)} shapes (JAX sweep "
          f"x f32/bf16 at bk 256, clamp/pad T 72, the card's plan at each of "
          f"the {served} kv_lens the served families decode, kv_len 1, 64 "
          f"(one split) and T, bk 100 (not dividing T), bf16, poisoned tail; "
          f"plans {sorted(fd_plans)[:4]}...): max abs err f32 "
          f"{fd_err[torch.float32]:.3g}, bf16 {fd_err[torch.bfloat16]:.3g}; "
          f"two calls bit-identical on all {fd_same}, one launch a call")
    print(f"      of which the new families' shapes: flash_attention "
          f"{len(new_fa)} (whisper's encoder, decoder and cross-attention "
          f"over T {WHISPER_T}, hymba's windowed and global layers, the wide "
          f"GQA heads 64/4, 48/8 and 64/8 at S {SCORE_S} in bf16 and f32, "
          f"each family's scoring, warm-up and self-check forward), "
          f"flash_decode {len(new_fd) + 1} (G 16 = 64/4 at hd 128, G 5 = "
          f"25/5 at hd 64, G 6 = 48/8 at hd 128; kv_len 1, {PROMPT + 1}, "
          f"{PROMPT + NEW_GEN - 1}, T {T_srv}; f32 and bf16; G 16 at bk "
          f"2048) beside the served kv_lens: " + "; ".join(
              f"{Hq}/{Hkv} hd {hd} T {T} kv_len {kls[0]}..{kls[-1]}"
              for _, T, Hq, Hkv, hd, _, kls in fam_fd))
    # the statistics output and the sequence-parallel merge (phase 24):
    # at G 1, 4, 5, 8 and 16 in f32 and bf16, the output path bit-equal to
    # the one-shot call's, the log-sum-exp held to the twin's, and the
    # merge (distributed.tp.merge_partials) of 2, 4 and 16 key shards,
    # some with no visible key, held to the unsharded call
    from repro_torch.distributed import tp as tpm
    merges, lse_err, merge_err = 0, 0.0, {}
    for Hq, Hkv, hd in ((8, 8, 64), (32, 8, 128), (25, 5, 64),
                        (64, 8, 128), (64, 4, 128)):
        for dt in (torch.float32, torch.bfloat16):
            T, kl = 1152, 700
            q, k, v = qkv(dt, SERVE_B, 1, T, Hq, Hkv, hd)
            one = fd.flash_decode(q, k, v, kl)
            o, lse = fd.flash_decode(q, k, v, kl, stats=True)
            label = f"flash_decode stats Hq{Hq}/{Hkv} hd{hd} {str(dt)[6:]}"
            check(torch.equal(o, one), f"{label}: the output with the "
                  f"statistics differs from the one-shot call's")
            lse_err = max(lse_err, held(label, lse, fd.flash_decode_plain(
                q, k, v, kl, stats=True)[1], torch.float32)[0])
            want = fd.flash_decode_plain(q, k, v, kl)
            for R in (2, 4, 16):
                Tl = T // R
                parts = [fd.flash_decode(
                    q, k[:, r * Tl:(r + 1) * Tl], v[:, r * Tl:(r + 1) * Tl],
                    min(max(kl - r * Tl, 0), Tl), stats=True)
                    for r in range(R)]
                got = tpm.merge_partials(
                    torch.stack([p[0].reshape(SERVE_B, Hq, hd)
                                 for p in parts]),
                    torch.stack([p[1] for p in parts])).reshape(one.shape)
                err = held(f"{label}: merge of {R} shards", got, want,
                           dt)[0]
                merge_err[dt] = max(merge_err.get(dt, 0.0), err)
                merges += 1
    del q, k, v, one, o, lse, want, parts, got
    print(f"      flash_decode statistics: the output with them bit-equal "
          f"to the one-shot call's at G 1, 4, 5, 8, 16 (f32, bf16), lse "
          f"within {lse_err:.3g} of the twin's; {merges} merges of 2, 4 and "
          f"16 key shards of 1152 (kv_len 700: shards with no visible key "
          f"launch nothing) == the unsharded call: max abs err f32 "
          f"{merge_err[torch.float32]:.3g}, bf16 "
          f"{merge_err[torch.bfloat16]:.3g}")
    print(f"      worst |got - want| / (atol + rtol |want|) outside bf16 "
          f"flash_attention: f32 {worst[torch.float32]:.3g} (2e-5, 2e-5), "
          f"bf16 {worst[torch.bfloat16]:.3g} (8e-3, 1e-3)")

    # times at the main path's shapes: bf16 (tensor-core path) at the
    # scoring shape, then f32 below
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
    # f32 (the 3xTF32 path) at the self-check's shape and at the scoring
    # shape, in turns with the parent's kernel where given (parent,
    # change, change, parent)
    f32 = {}
    for key, B, S in (("self_check", SERVE_B, PROMPT + GEN - 1),
                      ("scoring", SCORE_B, SCORE_S)):
        q, k, v = qkv(torch.float32, B, S, S, 32, 8, 128)
        run = lambda: fa.flash_attention(q, k, v)
        ms, par = [], []
        for who in (("parent", "change", "change", "parent") if parent
                    else ("change", "change")):
            with ab.swap(parent if who == "parent" else None):
                (par if who == "parent" else ms).append(time_ms(run, 10))
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
        want = fa.flash_attention_plain(q, k, v)
        err, ratio = held(f"flash_attention f32 at the {key} shape", run(),
                          want, torch.float32)[::2]
        bound, by = fa_tf32x3_bound_ms(B, S, S, 32, 8, 128, True, -1)
        f32[key] = dict(
            shape=[B, S, 32, 8, 128], ms=min(ms), ms_runs=ms,
            parent_ms=min(par) if par else None, parent_runs=par or None,
            plain_ms=plain, library_ms=sdpa_ms(q, k, v, True, 5),
            bound_ms=bound, bound_by=by,
            cuda_core_bound_ms=fa_bound_ms(B, S, S, 32, 8, 128, True, -1,
                                           torch.float32)[0],
            max_abs_err=err, gate_ratio=ratio)
        del q, k, v, want, run
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
    del q, k, v
    # qwen3_moe's decode shape: G 16 (64 q-heads over 4 kv-heads), the
    # mean kv_len of phase 17's 31 steps
    kl16, T16 = PROMPT + NEW_GEN // 2, PROMPT + NEW_GEN + 8
    q, k, v = qkv(torch.float32, SERVE_B, 1, T16, 64, 4, 128)
    bk16, ns16 = fd.plan(q, k, kl16)
    g16 = dict(
        shape=[SERVE_B, T16, kl16, 64, 4, 128], bk=bk16, ns=ns16,
        ms=device_ms(lambda: fd.flash_decode(q, k, v, kl16), 300),
        host_us=min(host_us(lambda: fd.flash_decode(q, k, v, kl16), 300)
                    for _ in range(3)),
        plain_ms=time_ms(lambda: fd.flash_decode_plain(q, k, v, kl16), 50),
        library_ms=sdpa_ms(q, k[:, :kl16], v[:, :kl16], False, 200),
        max_abs_err=held("flash_decode at qwen3_moe's decode shape",
                         fd.flash_decode(q, k, v, kl16),
                         fd.flash_decode_plain(q, k, v, kl16, bk=bk16),
                         torch.float32)[0])
    g16["bound_ms"], g16["bound_by"] = fd_bound_ms(SERVE_B, 64, 4, 128, kl16,
                                                   torch.float32)
    del q, k, v
    # the other served decode heads, each at its family's mid kv_len
    by_head = {}
    for arch, (B, T, Hq, Hkv, hd, dt, kls) in zip(
            (ARCH, MOE, VLM, HYMBA, WHISPER), fam_fd):
        if arch in (ARCH, MOE):          # timed above
            continue
        kl_h = kls[len(kls) // 2]
        q, k, v = qkv(dt, B, 1, T, Hq, Hkv, hd)
        bk_h, ns_h = fd.plan(q, k, kl_h)
        by_head[arch] = dict(
            shape=[B, T, kl_h, Hq, Hkv, hd], bk=bk_h, ns=ns_h,
            ms=device_ms(lambda: fd.flash_decode(q, k, v, kl_h), 300),
            bound_ms=fd_bound_ms(B, Hq, Hkv, hd, kl_h, dt)[0])
        del q, k, v
    # phase 24's rank: all 32 q-heads over a TP-th of the cache, every key
    # of it seen, with the statistics
    Tl = T_srv // TP
    q, k, v = qkv(torch.float32, SERVE_B, 1, Tl, 32, 8, 128)
    tp_rank = dict(
        shape=[SERVE_B, Tl, Tl, 32, 8, 128], plan=list(fd.plan(q, k, Tl)),
        ms=device_ms(lambda: fd.flash_decode(q, k, v, Tl, stats=True), 300),
        plain_ms=time_ms(lambda: fd.flash_decode_plain(q, k, v, Tl,
                                                       stats=True), 50),
        bound_ms=fd_bound_ms(SERVE_B, 32, 8, 128, Tl, torch.float32)[0])
    del q, k, v
    tflops = 4 * 128 * visible_pairs(SCORE_S, SCORE_S, True, -1) \
        * SCORE_B * 32 / fa_ms / 1e9
    print(f"      flash_attention bf16, tensor-core path [B{SCORE_B} "
          f"S{SCORE_S} Hq32/8 hd128 causal]: kernel {fa_ms:.4f} ms "
          f"({tflops:.1f} TFLOP/s), plain {fa_plain:.4f} ms, sdpa "
          f"{fa_lib:.4f} ms, bound {fa_bound:.4f} ms ({fa_by})")
    for key, r in f32.items():
        B, S = r["shape"][:2]
        par = ("parent " + " / ".join(
            f"{x:.4f}" for x in r["parent_runs"]) + " ms, "
            if r["parent_runs"] else "parent not given, ")
        print(f"      flash_attention f32, 3xTF32 path [B{B} S{S} Hq32/8 "
              f"hd128 causal] ({key}): kernel " + " / ".join(
                  f"{x:.4f}" for x in r["ms_runs"]) + f" ms, {par}plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, 3xTF32 over "
              f"{H100_TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; "
              f"{r['bound_ms'] / r['ms']:.3f} of it), CUDA-core bound "
              f"{r['cuda_core_bound_ms']:.4f} ms; max abs err "
              f"{r['max_abs_err']:.3g}, {r['gate_ratio']:.3g} x the gate")
    print(f"      flash_decode f32 [B{SERVE_B} T{T_srv} kv_len {kl} Hq32/8 "
          f"hd128], the card's plan bk {fd_bk} x {fd_ns} splits "
          f"({fd_ns * 8 * SERVE_B} blocks): kernel {fd_ms:.5f} ms of device "
          f"time a call, plain {fd_plain:.4f} ms, sdpa {fd_lib:.4f} ms, bound "
          f"{fd_bound:.5f} ms ({fd_by})")
    print(f"      flash_decode host path: {fd_host:.2f} us a call (best of 3 "
          f"x 300 calls enqueued before one synchronize), beside "
          f"{fd_ms * 1e3:.2f} us of device time, a {fd_bound * 1e3:.2f} us "
          f"bound and sdpa's {fd_lib * 1e3:.2f} us")
    print(f"      flash_decode f32 at G 16 [B{SERVE_B} T{T16} kv_len {kl16} "
          f"Hq64/4 hd128] (qwen3_moe's decode), plan bk {bk16} x {ns16} "
          f"splits ({ns16 * 4 * SERVE_B} blocks): kernel {g16['ms']:.5f} ms "
          f"of device time a call, host {g16['host_us']:.2f} us, plain "
          f"{g16['plain_ms']:.4f} ms, sdpa {g16['library_ms']:.4f} ms, bound "
          f"{g16['bound_ms']:.5f} ms ({g16['bound_by']}); max abs err "
          f"{g16['max_abs_err']:.3g}")
    print("      flash_decode f32 at the other served heads, device time a "
          "call: " + "; ".join(
              f"{a} [B{r['shape'][0]} T{r['shape'][1]} kv_len "
              f"{r['shape'][2]} Hq{r['shape'][3]}/{r['shape'][4]} hd"
              f"{r['shape'][5]}] plan {r['bk']} x {r['ns']}: "
              f"{r['ms']:.5f} ms, bound {r['bound_ms']:.5f} ms"
              for a, r in by_head.items()))
    r = tp_rank
    print(f"      flash_decode f32 with statistics at phase 24's rank shape "
          f"[B{SERVE_B} T{r['shape'][1]} kv_len {r['shape'][2]} Hq32/8 "
          f"hd128] plan {r['plan'][0]} x {r['plan'][1]}: kernel "
          f"{r['ms']:.5f} ms of device time a call, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms")
    sc = f32["self_check"]
    return {"flash_attention": dict(
                max_abs_err=fa_main_err, ms=fa_ms, plain_ms=fa_plain,
                bound_ms=fa_bound, bound_by=fa_by, library_ms=fa_lib,
                path="tensor_core", worst_err_ratio_strict=fa_strict,
                worst_err_ratio=fa_gated),
            "flash_attention_f32": dict(
                max_abs_err=sc["max_abs_err"], ms=sc["ms"],
                plain_ms=sc["plain_ms"], bound_ms=sc["bound_ms"],
                bound_by=sc["bound_by"], library_ms=sc["library_ms"],
                path=fa.PATHS[torch.float32],
                cuda_core_bound_ms=sc["cuda_core_bound_ms"],
                parent_ms=sc["parent_ms"], shape=sc["shape"],
                worst_gate_ratio=worst[torch.float32],
                large_scores={k: {"err": g, "twin_err": t}
                              for k, (g, t) in big.items()},
                scoring=f32["scoring"]),
            "flash_decode": dict(max_abs_err=fd_main_err, ms=fd_ms,
                                 plain_ms=fd_plain, bound_ms=fd_bound,
                                 bound_by=fd_by, library_ms=fd_lib,
                                 host_us=fd_host, bk=fd_bk, ns=fd_ns,
                                 g16=g16, heads=by_head, tp_rank=tp_rank)}


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
            "fa_tensor_core_tf32x3": fa.STATS.tensor_core_tf32x3,
            "flash_decode": fd.STATS.launches,
            "wkv6": rk.STATS.launches}


def launched(n: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in n.items() if v) or "none"


def expect_counts(label: str, n: dict, **want) -> None:
    """The counts are ``want`` for the named kernels and 0 for the rest."""
    full = {k: want.get(k, 0) for k in n}
    check(n == full, f"{label} launched {n}, expected {full}")


def self_check(dev, arch: str, served: dict, phase: int, *,
               want_prefill=None, want_step=None, parent=None,
               **want) -> dict:
    """Phases 11, 15, 17 and 19-21: an f32 ``forward`` over
    ``replay_batch`` (the prompt and the tokens fed back) reproduces the
    served logits and tokens (``logits_held``); its launches are ``want``.
    With ``want_prefill`` and ``want_step``, one prefill of the prompt and
    one decode step after it launch exactly those kernels.  With
    ``parent`` (an ``ab_flash_attention.finish_build`` library) the
    forward is also timed with the parent's flash_attention, in turns.
    For a MoE config the forward covers the prompt alone (capacity is per
    routing group, so a longer group keeps other tokens) and the decode
    rows are held to a serve at ``impl="dense"`` instead.  Returns the
    forward's launches and walls."""
    import torch
    from repro_torch import ab_flash_attention as ab
    from repro_torch.launch import replay_batch
    from repro_torch.models import get_model
    cfg = family_config(arch)
    mod = get_model(cfg)
    batch, first = replay_batch(cfg, served)
    got, toks = served["logits"], served["tokens"]
    if cfg.n_experts:
        batch = {"tokens": batch["tokens"][:, :first + 1]}
        got, toks = got[:, :1], toks[:, :1]
    model = mod.init(cfg, seed=0, dtype=torch.float32, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    if arch == MOE:                      # phase 24 replays this forward
        with routes() as seen:
            full = mod.forward(model, batch)
        REF.update({"batch " + MOE: batch["tokens"].cpu().numpy(),
                    "routes " + MOE: seen,
                    "logits " + MOE: full[:, -TAIL:].float().cpu()})
        logits = full[:, first:]
        del full
    else:
        logits = mod.forward(model, batch)[:, first:]
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    n = counts()
    expect_counts(f"{arch} f32 forward", n, **want)
    parent_walls = []
    if parent is not None:               # parent, change, parent
        for who in ("parent", "change", "parent"):
            with ab.swap(parent if who == "parent" else None):
                t0 = time.perf_counter()
                mod.forward(model, batch)
                torch.cuda.synchronize()
                (parent_walls if who == "parent" else walls).append(
                    time.perf_counter() - t0)
    note = ""
    if want_prefill is not None:
        seq = batch["tokens"]
        reset_counts()
        lg, state = mod.prefill(model, {"tokens": seq[:, :first + 1]},
                                first + 9, cache_dtype=torch.float32)
        n_pre = counts()
        reset_counts()
        mod.decode_step(model, state, {"tokens": seq[:, first + 1:first + 2]})
        n_step = counts()
        expect_counts(f"{arch} prefill", n_pre, **want_prefill)
        expect_counts(f"{arch} decode step", n_step, **want_step)
        note = (f"; one prefill launches {launched(n_pre)}, one decode step "
                f"{launched(n_step)}")
        del lg, state
    del model
    torch.cuda.empty_cache()
    rows = (f"the prefill's row (a forward over the {first + 1}-token "
            "prompt)" if cfg.n_experts else
            f"positions {first}..{first + toks.shape[1] - 1}")
    text = logits_held(f"self-check {arch}", got, logits, toks)
    par = (", parent's flash_attention " + " / ".join(
        f"{x:.4f}" for x in parent_walls) + " s" if parent_walls else "")
    print(f"[{phase}/25] self-check {arch}: f32 forward over "
          f"{tuple(next(iter(batch.values())).shape)} (wall " + " / ".join(
              f"{x:.4f}" for x in walls) + f" s{par}; launches "
          f"{launched(n)}) reproduces the served logits at {rows}: "
          f"{text}{note}")
    del logits, batch
    if cfg.n_experts:
        dense = serving(dev, arch, phase, prompt=first + 1,
                        gen=served["tokens"].shape[1], impl="dense",
                        label=" (plain attention)")
        text = logits_held(f"{arch} kernel vs dense serve", served["logits"],
                           dense["logits"], served["tokens"])
        print(f"      {arch}: the kernel serve's {len(dense['tokens'][0])} rows "
              f"against the plain-attention serve's (same routing groups): "
              f"{text}")
        del dense
    torch.cuda.empty_cache()
    return {"launches": n, "wall_s": walls,
            "parent_wall_s": parent_walls or None}


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
    """Phase 11: ``wkv6`` against its plain twin, then timed at the scoring
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
    # phase 24's ranks: H / TP heads, the prefill and a decode step
    main_cases += [(SERVE_B, T, H // TP, n, None, "model", torch.float32,
                    False) for T in (PROMPT, 1)]
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
    sc32, sc16, pre, tp_pre, _ = main_cases
    print(f"[12/25] wkv6 == plain on {len(cases)} shapes (JAX sweep, strong "
          f"decay U{strong}, T not whole chunks, strided, bf16 r/k/v, "
          f"{RWKV} scoring in f32 and bf16 at tiles {tiles[sc32]} and "
          f"{tiles[sc16]}, the serving prefill at tile {tiles[pre]}, phase "
          f"24's rank ({H // TP} heads) prefill at tile {tiles[tp_pre]} and "
          f"decode step, the "
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


def _kept_rows(cand, valid, n_of):
    """Indices (c, k) of the candidates the corpus keeps: valid, and not an
    exact duplicate of an earlier one of the same condition."""
    kept = []
    for c in range(cand.shape[0]):
        seen = set()
        for k in range(cand.shape[1]):
            key = cand[c, k, : n_of[c] + 1].tobytes()
            if valid[c, k] and key not in seen:
                seen.add(key)
                kept.append((c, k))
    return kept


TRAIN_CKPT = ROOT / "build" / "smoke_train_ckpt"
UNSEEN_MB = (12, 24, 48)        # budgets the corpus never saw
HOST_CONDS = (0, 37, 74, 111)   # conditions the host mapper answers too


def paper_loop(dev, grid: dict, gsampler: dict, untrained: dict):
    """Phase 6: corpus, training and answer on the card.  ``grid`` holds the
    smoke grid (workloads, hws, batches, budgets, packed, n_of),
    ``gsampler`` phase 4's wall and best speedups, ``untrained`` phase 5's
    valid share, speedup and wall.  Returns the ``fusion_eval`` launches of
    the paths it drives and the trained DT."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core import (accel, cost_model as cm, dataset as ds_,
                                  env as env_, gsampler as gs, infer,
                                  model as dtm, train)
    from repro_torch.workloads import CNN_ZOO
    from repro_torch.workloads.grid import paper_grid
    C = len(grid["workloads"])
    packed, batches, budgets, hws = (grid[k] for k in ("packed", "batches",
                                                       "budgets", "hws"))
    nets = [CNN_ZOO[n]() for n in sorted(CNN_ZOO)]
    parts = [accel.ACCEL_ZOO[p] for p in sorted(accel.ACCEL_ZOO)]
    ga = gs.GSamplerConfig()
    top_k, jitter = 8, 2

    # -- corpus -------------------------------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    corpus = ds_.generate_teacher_corpus(
        nets, parts, batch=BATCH, budgets_mb=list(BUDGETS_MB),
        max_steps=NMAX, top_k=top_k, ga_cfg=ga, seed=0,
        augment_jitter=jitter, device=dev)
    torch.cuda.synchronize()
    corpus_wall = time.perf_counter() - t0
    n = counts()
    want = 18 + ga.generations * (1 + ga.repair_tries) + 1
    expect_counts("corpus", n, fusion_eval=want)
    corpus_launches = n["fusion_eval"]
    # replay the pipeline's steps (deterministic per seed): the decoration's
    # final costs against the kernel's re-score of the same candidates, and
    # the replay's kept rows against the corpus
    res = gs.gsampler_search_grid(grid["workloads"], hws, batches, budgets,
                                  nmax=NMAX, cfg=ga, top_k=top_k,
                                  packed=packed, device=dev)
    cand = ds_._augment_candidates(np.random.default_rng(0), res.strategies,
                                   grid["n_of"], BATCH, top_k, jitter)
    _, rtg, _, _, fin = ds_._decorate_grid(packed, cand, batches, budgets,
                                           hws)
    re = cm.evaluate_grid(packed, cand, batches, budgets, hws)
    for k in ("latency", "peak_mem", "traffic"):
        a, b = getattr(re, k).cpu().numpy(), getattr(fin, k).cpu().numpy()
        check(np.isfinite(b).all() and np.allclose(a, b, rtol=1e-5, atol=0),
              f"corpus {k}: prefix_scan final differs from the kernel "
              f"re-score (max rel {np.max(np.abs(a - b) / np.abs(b))})")
    check(torch.equal(re.valid, fin.valid) and
          torch.equal(re.n_groups, fin.n_groups),
          "corpus: valid / n_groups of prefix_scan differ from the kernel")
    rtg = rtg.cpu().numpy()
    kept = [rtg[c, k] for c, k in _kept_rows(cand, fin.valid.cpu().numpy(),
                                             grid["n_of"])]
    check(len(kept) == len(corpus) and
          np.array_equal(np.stack(kept), corpus.rtg),
          "corpus: a replay of the pipeline keeps other rows")
    sp = np.array([m[2] for m in corpus.meta])
    print(f"[6/25] corpus: generate_teacher_corpus over {C} conditions "
          f"(GA pop {ga.population} x {ga.generations}, top {top_k} + "
          f"{jitter} jittered copies of the top {top_k // 2}, {cand.shape[1]}"
          f" candidates a condition): wall {corpus_wall:.3f} s, "
          f"fusion_eval launches {corpus_launches} (GA {want}, decoration 0)"
          f", {len(corpus)} rows kept of {cand.shape[0] * cand.shape[1]}, "
          f"mean teacher speedup {sp.mean():.4f}; prefix_scan finals == "
          f"kernel re-score (rtol 1e-5, valid and n_groups equal), replay "
          f"rows equal")

    # -- training -----------------------------------------------------------
    cfg = dtm.DTConfig(hw_dim=accel.HW_FEATURE_DIM)
    tc = train.TrainConfig()            # the reference's: 3000 steps, ...
    model = dtm.dt_init(cfg, seed=0, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, log = train.train_model(dtm.dt_loss, model, corpus, tc,
                                   device=dev)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    expect_counts("training", counts())
    losses = [l for _, l in log["losses"]]
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"training loss did not fall: {log['losses']}")
    print(f"      training: train_model, DT 3x2x128 hw_dim 10, "
          f"{tc.steps} steps of batch {tc.batch_size} (lr {tc.lr}, warmup "
          f"{tc.warmup}, cosine, decay {tc.weight_decay}, clip "
          f"{tc.max_grad_norm}): wall {train_wall:.2f} s, "
          f"{train_wall / tc.steps * 1e3:.3f} ms a step (host clock, the "
          f"loop ends in a sync); loss " + ", ".join(
              f"{s}: {l:.5f}" for s, l in log["losses"]))
    # bit-exact: twice from one seed, and a crash at step 10 plus a resume
    short = train.TrainConfig(steps=20, log_every=5, ckpt_every=10, seed=1)
    runs = []
    for _ in range(2):
        runs.append(train.train_model(
            dtm.dt_loss, dtm.dt_init(cfg, seed=1, device=dev), corpus,
            short, device=dev)[0])
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    train.train_model(dtm.dt_loss, dtm.dt_init(cfg, seed=1, device=dev),
                      corpus, short, ckpt_dir=TRAIN_CKPT, crash_at=10,
                      device=dev)
    resumed, rlog = train.train_model(
        dtm.dt_loss, dtm.dt_init(cfg, seed=1, device=dev), corpus, short,
        ckpt_dir=TRAIN_CKPT, device=dev)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    check(rlog["start_step"] == 10, "resume did not start at step 10")
    trees = [dtm.param_tree(m) for m in runs + [resumed]]
    for other in trees[1:]:
        check(all(torch.equal(trees[0][k], other[k]) for k in trees[0]),
              "training on the card is not bit-exact (same seed, or resume)")
    print(f"      20 steps twice from one seed and once crashed at step 10 "
          f"and resumed: parameters bit-identical ({len(trees[0])} leaves)")

    # -- answer -------------------------------------------------------------
    infer.dnnfuser_infer_batch(model, packed, batches, budgets, hws,
                               device=dev)             # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = infer.dnnfuser_infer_batch(model, packed, batches, budgets, hws,
                                     device=dev)
    torch.cuda.synchronize()
    dt_wall = time.perf_counter() - t0
    re = cm.evaluate_grid(packed, out["strategy"][:, None, :], batches,
                          budgets, hws)
    torch.cuda.synchronize()
    n = counts()
    expect_counts("trained answer + re-score", n, fusion_eval=1)
    answer_launches = n["fusion_eval"]
    for k in ("latency", "peak_mem", "traffic"):
        a = getattr(re, k)[:, 0].cpu().numpy()
        b = out[k].cpu().numpy()
        check(np.isfinite(b).all() and np.allclose(a, b, rtol=1e-5, atol=0),
              f"trained DT {k} differs from the kernel re-score")
    check(torch.equal(re.valid[:, 0], out["valid"]) and
          torch.equal(re.n_groups[:, 0], out["n_groups"]),
          "trained DT valid / n_groups differ from the kernel re-score")
    v = out["valid"].cpu().numpy()
    speed = out["speedup"].cpu().numpy()
    dt_speed = speed[v].mean() if v.any() else 0.0
    print(f"      trained DT one shot over {C} conditions: wall "
          f"{dt_wall:.4f} s, valid share {v.mean():.4f}, mean valid speedup "
          f"{dt_speed:.4f} (G-Sampler best {gsampler['best'].mean():.4f}, "
          f"valid {gsampler['valid']:.4f}; untrained DT "
          f"{untrained['speedup']:.4f}, valid {untrained['valid']:.4f}); "
          f"re-score matches (rtol 1e-5); G-Sampler/DT wall ratio "
          f"{gsampler['wall'] / dt_wall:.2f} (untrained "
          f"{gsampler['wall'] / untrained['wall']:.2f})")

    # budgets the corpus never saw, beside a G-Sampler search of them
    ucond, uw, ub, ubud = paper_grid(sorted(accel.ACCEL_ZOO), UNSEEN_MB,
                                     BATCH)
    uhws = [accel.ACCEL_ZOO[p] for _, p, _ in ucond]
    upacked = cm.stack_workloads([cm.pack_workload(w, h, NMAX, device=dev)
                                  for w, h in zip(uw, uhws)])
    uout = infer.dnnfuser_infer_batch(model, upacked, ub, ubud, uhws,
                                      device=dev)
    ures = gs.gsampler_search_grid(uw, uhws, ub, ubud, nmax=NMAX, cfg=ga,
                                   top_k=1, packed=upacked, device=dev)
    uv = uout["valid"].cpu().numpy()
    usp = uout["speedup"].cpu().numpy()
    ubest = np.where(ures.valid, ures.speedup, 0.0).max(1)
    print(f"      unseen budgets {UNSEEN_MB} MB ({len(ucond)} conditions, "
          f"informative): trained DT valid share {uv.mean():.4f}, mean valid "
          f"speedup {usp[uv].mean() if uv.any() else 0.0:.4f}; G-Sampler "
          f"valid {ures.valid[:, 0].mean():.4f}, mean best {ubest.mean():.4f}"
          f"; DT / G-Sampler speedup per condition, mean "
          f"{np.mean(np.where(uv, usp, 0.0) / np.maximum(ubest, 1e-12)):.4f}")

    # the host mapper on a few conditions, against the fused episode
    strat = out["strategy"].cpu().numpy()
    same, host_launches = 0, 0
    for c in HOST_CONDS:
        env = env_.FusionEnv(grid["workloads"][c], hws[c], BATCH,
                             float(budgets[c]), nmax=NMAX, device=dev)
        before = counts()["fusion_eval"]
        r = infer.dnnfuser_infer(model, env)
        host_launches += counts()["fusion_eval"] - before
        same += int(np.array_equal(r.strategy, strat[c]))
    check(host_launches > 0, "the host mapper launched no fusion_eval")
    print(f"      host dnnfuser_infer on {len(HOST_CONDS)} conditions: "
          f"{same} of {len(HOST_CONDS)} strategies equal the fused "
          f"episode's; {host_launches} fusion_eval launches (one per env "
          f"state and guard probe)")
    return corpus_launches + answer_launches + host_launches, model


STREAM_N = 480                  # requests of the serving stream
ALONE_N = 32                    # of them served alone by fresh engines
LOW_MB = (0.25, 0.5, 1)         # budgets low enough to be over budget
SERVE_CACHE = ROOT / "build" / "smoke_strategies.json"


def _same_response(a, b) -> bool:
    """All five fields bit for bit."""
    import numpy as np
    return bool(np.array_equal(a.strategy, b.strategy) and
                (a.latency, a.peak_mem, a.speedup, a.valid) ==
                (b.latency, b.peak_mem, b.speedup, b.valid))


def _rescore(eng, reqs, strategies):
    """(latency, peak, valid) of each request's trimmed strategy, scored by
    ``fusion_eval`` (one ``evaluate_grid`` call per nmax bucket, rows packed
    as the engine packs them)."""
    import numpy as np
    from repro_torch.core import cost_model as cm
    from repro_torch.serving import nmax_bucket
    out = np.zeros((3, len(reqs)))
    by_nb = {}
    for i, r in enumerate(reqs):
        by_nb.setdefault(nmax_bucket(r.workload.n + 1, eng.nmax_buckets),
                         []).append(i)
    for nb, idx in by_nb.items():
        s = np.full((len(idx), 1, nb), cm.SYNC, np.int32)
        for j, i in enumerate(idx):
            s[j, 0, :len(strategies[i])] = strategies[i]
        re = cm.evaluate_grid(
            cm.stack_workloads([eng._pack(reqs[i].workload, reqs[i].accel,
                                          nb) for i in idx]), s,
            np.array([reqs[i].batch for i in idx], np.float32),
            np.array([reqs[i].budget_bytes for i in idx], np.float32),
            [reqs[i].accel for i in idx])
        for k, f in enumerate(("latency", "peak_mem", "valid")):
            out[k, idx] = getattr(re, f)[:, 0].cpu().numpy()
    return out


def _fitness(latency, peak, budget) -> float:
    """The teacher's fitness (valid beats invalid, then latency, then
    overshoot)."""
    import numpy as np
    from repro_torch.core.gsampler import _fitness as fit
    return float(fit(np.float32(latency), np.float32(peak),
                     np.float32(budget)))


def mapper_serving(dev, model) -> int:
    """Phase 7: the serving stack on the card with phase 6's trained DT.
    Returns the ``fusion_eval`` launches of the paths it drives (the
    refinement and the refresh; the one-shot stream launches none)."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.core import accel, cost_model as cm, infer
    from repro_torch.serving import (AsyncMapperScheduler, MapperEngine,
                                     MapRequest, RefreshWorker,
                                     ServingConfig, nmax_bucket)
    from repro_torch.serving.engine import _accel_key
    from repro_torch.workloads import CNN_ZOO
    from repro_torch.workloads.grid import SERVE_BUDGETS_MB, serving_stream
    parts = sorted(accel.ACCEL_ZOO)
    nets = {n: CNN_ZOO[n]() for n in sorted(CNN_ZOO)}
    zoo = accel.ACCEL_ZOO
    req = lambda n, p, b, bt: MapRequest(nets[n], bt, b * MB, zoo[p])
    launches = {}

    # -- 1. warm up and stream ---------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = repro_torch.serve(model, warm=list(nets.values()), device=dev)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    eng = sched.engine
    sigs = eng.compile_count
    conds, arrivals = serving_stream(parts, STREAM_N, seed=0)
    reqs = [req(*c) for c in conds]
    calls0, hist0 = eng.device_calls, dict(eng.coalesce_hist)
    reset_counts()
    t0 = time.perf_counter()
    futs, last = [], 0.0
    for r, a in zip(reqs, arrivals):
        if a > last + sched.flush_s:    # the last burst's flush timer fires
            sched.pump(now=last + sched.flush_s)
        futs.append(sched.submit(r, now=a))
        sched.pump(now=a)
        last = a
    sched.drain(now=last + sched.flush_s)
    stream_wall = time.perf_counter() - t0
    launches["stream"] = counts()
    expect_counts("serving stream", launches["stream"])
    resp = [f.result() for f in futs]
    lat = np.array(sorted(f.latency_s for f in futs))
    calls = eng.device_calls - calls0
    lanes = sum(k * (v - hist0.get(k, 0))
                for k, v in eng.coalesce_hist.items())
    keys = [eng._strategy_key(r) for r in reqs]
    unique = len(set(keys))
    check(eng.compile_count == sigs, f"the stream added "
          f"{eng.compile_count - sigs} signatures after warmup")
    check(lanes == unique, f"{lanes} episode lanes for {unique} unique "
          f"conditions: a repeat took a lane")
    seen = set()
    for k, r in zip(keys, resp):
        check(k not in seen or r.cached, "a repeat was not answered from "
              "the cache")
        seen.add(k)
    # against the batched episode and a kernel re-score, per nmax bucket
    first = {}
    for i, k in enumerate(keys):
        first.setdefault(k, i)
    by_nb = {}
    for i in first.values():
        by_nb.setdefault(nmax_bucket(reqs[i].workload.n + 1,
                                     eng.nmax_buckets), []).append(i)
    for nb, idx in sorted(by_nb.items()):
        rows = [cm.pack_workload(reqs[i].workload, reqs[i].accel, nb,
                                 device=dev) for i in idx]
        wls = cm.stack_workloads(rows)
        b = np.array([reqs[i].batch for i in idx], np.float32)
        m = np.array([reqs[i].budget_bytes for i in idx], np.float32)
        hw = [reqs[i].accel for i in idx]
        out = infer.dnnfuser_infer_batch(model, wls, b, m, hw, device=dev)
        strat = out["strategy"].cpu().numpy()
        got = np.full((len(idx), nb), cm.SYNC, np.int32)
        for j, i in enumerate(idx):
            n1 = reqs[i].workload.n + 1
            check(np.array_equal(resp[i].strategy, strat[j, :n1]),
                  f"served strategy {conds[i]} differs from "
                  f"dnnfuser_infer_batch's")
            got[j, :n1] = resp[i].strategy
        re = cm.evaluate_grid(wls, got[:, None, :], b, m, hw)
        for f in ("latency", "peak_mem"):
            a = getattr(re, f)[:, 0].cpu().numpy()
            w = np.array([getattr(resp[i], f) for i in idx], np.float32)
            check(np.allclose(w, a, rtol=1e-5, atol=0), f"served {f} differs "
                  f"from the kernel re-score (bucket {nb})")
        check(np.array_equal(re.valid[:, 0].cpu().numpy(),
                             np.array([resp[i].valid for i in idx])),
              f"served valid differs from the kernel re-score (bucket {nb})")
    hits = sum(r.cached for r in resp)
    print(f"[7/25] serving on the card: repro_torch.serve(trained DT, "
          f"warm=6 CNNs), default ServingConfig: warmup {warm_wall:.3f} s, "
          f"{sigs} signatures {sorted(eng._compiled)}; stream of "
          f"{STREAM_N} requests (6 CNNs x 5 parts x budgets "
          f"{list(SERVE_BUDGETS_MB)} MB x batch 16/64, bursts of 16-64 "
          f"every 2 s of scheduler clock) in "
          f"{stream_wall:.3f} s = {STREAM_N / stream_wall:.1f} req/s; "
          f"request latency p50 {np.percentile(lat, 50) * 1e3:.1f} ms, "
          f"p99 {np.percentile(lat, 99) * 1e3:.1f} ms (scheduler clock); "
          f"{calls} episode calls for {unique} unique conditions, "
          f"{hits} answered from the cache (hit rate "
          f"{hits / STREAM_N:.4f}); 0 new signatures; strategies == "
          f"dnnfuser_infer_batch, costs == fusion_eval re-score "
          f"(rtol 1e-5)")

    # -- 2. bit-identity: alone, and a permuted replay ----------------------
    rng = np.random.default_rng(1)
    alone = rng.choice(STREAM_N, ALONE_N, replace=False)
    t0 = time.perf_counter()
    for i in alone:
        one = MapperEngine(model, device=dev).serve_one(reqs[i])
        check(_same_response(one, resp[i]), f"request {conds[i]} alone "
              f"differs from its answer in the stream")
    alone_wall = time.perf_counter() - t0
    order = rng.permutation(STREAM_N)
    replay = AsyncMapperScheduler(MapperEngine(model, device=dev))
    rfut = {}
    for t, i in zip(arrivals, order):
        rfut[i] = replay.submit(reqs[i], now=t)
        replay.pump(now=t)
    replay.drain(now=arrivals[-1])
    for i in range(STREAM_N):
        check(_same_response(rfut[i].result(), resp[i]), f"request "
              f"{conds[i]} differs in the permuted replay")
    print(f"      bit-identity: {ALONE_N} requests each served alone by a "
          f"fresh engine ({alone_wall:.2f} s) and the permuted replay of "
          f"all {STREAM_N}: every field bit-identical")

    # -- 3. persisted cache --------------------------------------------------
    SERVE_CACHE.unlink(missing_ok=True)
    saved = eng.save_cache(SERVE_CACHE)
    fresh = MapperEngine(model, device=dev,
                         config=ServingConfig(cache_path=SERVE_CACHE))
    t0 = time.perf_counter()
    again = fresh.serve(reqs)
    cache_wall = time.perf_counter() - t0
    SERVE_CACHE.unlink(missing_ok=True)
    check(fresh.device_calls == 0, f"warm restart made "
          f"{fresh.device_calls} episode calls")
    check(all(_same_response(a, b) for a, b in zip(again, resp)),
          "warm restart answers differ from the stream's")
    print(f"      persisted cache: {saved} entries saved, a fresh engine "
          f"loaded them and answered the stream in {cache_wall:.4f} s with "
          f"0 episode calls, bit-identical")

    # -- 4. polish and escalation --------------------------------------------
    grid = [(n, p, float(b), 64) for n in nets for p in parts
            for b in BUDGETS_MB + LOW_MB]
    greqs = [req(*c) for c in grid]
    e = MapperEngine(model, device=dev,
                     config=ServingConfig(polish=True, escalate=True))
    # the one-shot answers: the engine's episode is dnnfuser_infer_batch's
    # (checked on the stream above), so one call per nmax bucket
    plain = [None] * len(greqs)
    by_nb = {}
    for i, r in enumerate(greqs):
        by_nb.setdefault(nmax_bucket(r.workload.n + 1, e.nmax_buckets),
                         []).append(i)
    for nb, idx in by_nb.items():
        out = infer.dnnfuser_infer_batch(
            model, cm.stack_workloads([e._pack(greqs[i].workload,
                                               greqs[i].accel, nb)
                                       for i in idx]),
            [64.0] * len(idx), [greqs[i].budget_bytes for i in idx],
            [greqs[i].accel for i in idx], device=dev)
        st, va = out["strategy"].cpu().numpy(), out["valid"].cpu().numpy()
        for j, i in enumerate(idx):
            plain[i] = (st[j, :greqs[i].workload.n + 1], bool(va[j]))
    over = sum(not v for _, v in plain)
    check(over >= 8, f"only {over} one-shot answers over budget")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined = e.serve(greqs)
    wall = time.perf_counter() - t0
    launches["refine"] = counts()
    rst = e.stats()
    check(launches["refine"]["fusion_eval"] > 0,
          "refinement launched no fusion_eval")
    # a second run, over every third condition (other chunks, other lane
    # neighbours): bit-identical answers
    again = MapperEngine(model, device=dev, config=ServingConfig(
        polish=True, escalate=True)).serve(greqs[::3])
    check(all(_same_response(a, b) for a, b in zip(again, refined[::3])),
          "polish + escalation differ between two runs")
    # both answers scored by the same evaluator (the one-shot costs come
    # from the episode's prefix carry, which agrees with fusion_eval to
    # rtol 1e-5, not bit for bit)
    pl = _rescore(e, greqs, [st for st, _ in plain])
    rf = _rescore(e, greqs, [r.strategy for r in refined])
    fixed = 0
    for i, (a, b, r) in enumerate(zip(plain, refined, greqs)):
        check(rf[0, i] == b.latency and rf[1, i] == b.peak_mem,
              "refined costs differ from their fusion_eval re-score")
        check(_fitness(*rf[:2, i], r.budget_bytes) >=
              _fitness(*pl[:2, i], r.budget_bytes),
              f"refinement worsened {r.workload.name} @ "
              f"{r.budget_bytes / MB} MB")
        fixed += int(b.valid and not a[1])
    print(f"      polish + escalation: {len(greqs)} conditions (the smoke "
          f"grid + budgets {list(LOW_MB)} MB), {over} one-shot answers "
          f"over budget, {fixed} made valid; wall {wall:.3f} s (polish "
          f"{e.polish_wall_s:.3f} s over {rst['polish_invocations']} "
          f"lanes, {rst['polish_improved']} improved; escalation "
          f"{e.escalate_wall_s:.3f} s over {rst['escalations']} lanes; "
          f"{rst['device_calls']} episodes); "
          f"{launched(launches['refine'])}; never worse by the teacher's "
          f"fitness; a second run over every third condition "
          f"bit-identical")

    # -- 5. drift, refresh and swap -----------------------------------------
    d = eng.stats()["drift"]
    check(d["reports_fired"] >= 1, "traffic on undeclared parts did not "
          "fire the drift monitor")
    snap = eng.strategies.snapshot()
    before = {k: v for k, v in snap.items() if k[3] == _accel_key(zoo["edge"])}
    sigs = eng.compile_count
    worker = RefreshWorker(eng, seed=0)
    reset_counts()
    t0 = time.perf_counter()
    res = worker.poll()
    refresh_wall = time.perf_counter() - t0
    launches["refresh"] = counts()
    check(res is not None, "no refresh ran on a fired report")
    if res["accepted"]:
        check(eng.compile_count == sigs, "the swap added signatures")
        snap = eng.strategies.snapshot()
        check(all(k in snap and np.array_equal(snap[k][0], v[0]) and
                  snap[k][1:] == v[1:] for k, v in before.items()),
              "cached answers outside the region changed across the swap")
    print(f"      drift: {d['reports_fired']} report(s), last "
          f"{d['last_report']['triggers']} on {d['last_report']['accels']}; "
          f"refresh {refresh_wall:.2f} s (corpus {res['corpus_size']} rows, "
          f"fine-tune loss {res['fine_tune_loss']:.5f}, probe live "
          f"{res['live_score']:.4f} vs candidate "
          f"{res['candidate_score']:.4f}): "
          f"{'accepted, swapped' if res['accepted'] else 'rejected'}, "
          f"{res['cache_invalidated']} entries invalidated, "
          f"{len(before)} edge entries kept bit-exact, 0 new signatures; "
          f"{launched(launches['refresh'])}")
    print("      launches per sub-phase: " + "; ".join(
        f"{k}: {launched(v)}" for k, v in launches.items()))
    return sum(v["fusion_eval"] for v in launches.values())


TABLE1_CASES = (("case1_20MB_B64", 64, 20.0), ("case2_40MB_B128", 128, 40.0))
TABLE1_NMAX = 20                # the reference's Table-1 env (max_steps 20)
TABLE1_SAMPLES = 2000           # the paper's sampling budget
BASELINE_POP = 40               # the baselines' population
A2C_EPISODES = 150              # the reference's quick budget (full: 1200)
TRAIN_MB = (16.0, 32.0, 48.0, 64.0)   # paper §5.3's imitation conditions
SEQ_STEPS, SEQ_BATCH = 400, 16  # the reference's Table-1 training
ANSWER_MB = (8, 12, 16, 20, 24, 32, 40, 48, 64)   # S2S batch-invariance set
# the reference's tractable optimality-gap slice (tiny_cnn, batch 64), less
# datacenter at 2 MB: its front is 5689 states, over the default front_cap
# of 4096, and it took 34 s of host time in the reference's CPU run
OPT_CELLS = (("edge", 2.0), ("edge", 6.0), ("nano", 2.0), ("nano", 6.0),
             ("datacenter", 6.0))


def paper_table(dev, trained) -> int:
    """Phase 16: the paper's Table 1 on VGG16 and the exact optimum on the
    reference's tractable slice, on the card through ``fusion_eval``;
    ``trained`` is phase 6's DT (its gap on the optimum's cells is printed).
    Returns the phase's ``fusion_eval`` launches."""
    import numpy as np
    import torch
    from repro_torch.core import (a2c, accel, baselines, cost_model as cm,
                                  dataset as ds_, env as env_, gsampler as gs,
                                  infer, model as dtm, optimal,
                                  seq2seq as sq, train)
    from repro_torch.workloads import tiny_cnn, vgg16
    total = [0]

    def run(label, fn, want=None):
        """``fn()`` with the counts read around it: exactly ``want``
        fusion_eval launches (at least one when None) and no other kernel;
        returns (result, launches)."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        n = counts()
        expect_counts(label, n, fusion_eval=n["fusion_eval"] if want is None
                      else want)
        check(want is not None or n["fusion_eval"] > 0,
              f"{label} launched no fusion_eval")
        total[0] += n["fusion_eval"]
        return out, n["fusion_eval"]

    def row(tag, name, sp, valid, peak, wall, launches):
        rows.append(f"      {tag:16s} {name:16s} speedup "
                    f"{(f'{sp:.4f}' if valid else 'N/A'):>7s}  usage "
                    f"{peak / MB:9.3f} MB  wall {wall:8.4f} s  fusion_eval "
                    f"{launches}")

    rows = []
    t_phase = time.perf_counter()
    per_run = TABLE1_SAMPLES // BASELINE_POP + 1
    for ci, (tag, batch, budget_mb) in enumerate(TABLE1_CASES):
        net = vgg16(batch=batch)
        steps = net.n + 1
        env = env_.FusionEnv(net, accel.PAPER_ACCEL, batch, budget_mb * MB,
                             nmax=TABLE1_NMAX, device=dev)
        cpu_env = env_.FusionEnv(net, accel.PAPER_ACCEL, batch,
                                 budget_mb * MB, nmax=TABLE1_NMAX,
                                 device="cpu")
        # -- the six black-box baselines, card against CPU -----------------
        for m in sorted(baselines.BASELINE_METHODS):
            r, k = run(f"{tag} {m}", lambda: baselines.run_baseline(
                env, m, budget=TABLE1_SAMPLES, seed=0), want=per_run)
            c = baselines.run_baseline(cpu_env, m, budget=TABLE1_SAMPLES,
                                       seed=0)
            check(np.array_equal(r.strategy, c.strategy) and
                  (r.latency, r.peak_mem, r.valid, r.n_evals) ==
                  (c.latency, c.peak_mem, c.valid, c.n_evals),
                  f"{tag} {m}: the card's run differs from the CPU's")
            row(tag, m, r.speedup, r.valid, r.peak_mem, r.wall_s, k)
        # -- A2C ------------------------------------------------------------
        r, k = run(f"{tag} A2C", lambda: a2c.a2c_search(
            env, budget=A2C_EPISODES, seed=0),
            want=A2C_EPISODES * (steps + 1) + 1)
        row(tag, f"A2C {A2C_EPISODES} ep", r.speedup, r.valid, r.peak_mem,
            r.wall_s, k)
        if ci == 0:
            a, _ = run("A2C determinism", lambda: a2c.a2c_search(
                env, budget=8, seed=5), want=8 * (steps + 1) + 1)
            b, _ = run("A2C determinism", lambda: a2c.a2c_search(
                env, budget=8, seed=5), want=8 * (steps + 1) + 1)
            check(np.array_equal(a.strategy, b.strategy) and
                  (a.latency, a.peak_mem) == (b.latency, b.peak_mem),
                  "two A2C runs of one seed differ on the card")
        # -- the host G-Sampler ---------------------------------------------
        g, k = run(f"{tag} G-Sampler", lambda: gs.gsampler_search(env))
        row(tag, "G-Sampler", g.speedup, g.valid, g.peak_mem, g.wall_s, k)
        # -- the sequence models: teacher data, training, one shot ----------
        t0 = time.perf_counter()
        data, k = run(f"{tag} teacher data", lambda: ds_.collect_teacher_data(
            [net], accel.PAPER_ACCEL, batch, list(TRAIN_MB),
            max_steps=TABLE1_NMAX, seed=0, device=dev))
        teach_wall = time.perf_counter() - t0
        scfg = sq.S2SConfig(max_steps=TABLE1_NMAX)
        t0 = time.perf_counter()
        s2s, slog = run(f"{tag} S2S training", lambda: train.train_model(
            sq.s2s_loss, sq.s2s_init(scfg, seed=0, device=dev), data,
            train.TrainConfig(steps=SEQ_STEPS, batch_size=SEQ_BATCH, seed=0),
            device=dev), want=0)[0]
        s2s_wall = time.perf_counter() - t0
        dcfg = dtm.DTConfig(max_steps=TABLE1_NMAX)
        t0 = time.perf_counter()
        dt, dlog = run(f"{tag} DT training", lambda: train.train_model(
            dtm.dt_loss, dtm.dt_init(dcfg, seed=0, device=dev), data,
            train.TrainConfig(steps=SEQ_STEPS, batch_size=SEQ_BATCH,
                              lr=3e-4, warmup=min(50, SEQ_STEPS // 5),
                              seed=0), device=dev), want=0)[0]
        dt_wall = time.perf_counter() - t0
        for log in (slog, dlog):
            ls = [l for _, l in log["losses"]]
            check(np.isfinite(ls).all() and ls[-1] < ls[0],
                  f"{tag}: training loss did not fall: {log['losses']}")
        one_shot = {}
        for name, model in (("Seq2Seq", s2s), ("DNNFuser", dt)):
            infer.dnnfuser_infer_fused(model, env)                 # warm-up
            r, k = run(f"{tag} {name} one shot",
                       lambda: infer.dnnfuser_infer_fused(model, env), want=0)
            one_shot[name] = r
            row(tag, f"{name} one shot", r.speedup, r.valid, r.peak_mem,
                r.wall_s, k)
        rows.append(f"      {tag:16s} teacher data {len(data)} rows in "
                    f"{teach_wall:.2f} s; training {SEQ_STEPS} steps of "
                    f"batch {SEQ_BATCH}: S2S {s2s_wall:.2f} s (loss "
                    f"{slog['losses'][0][1]:.4f} -> {slog['final_loss']:.4f})"
                    f", DT {dt_wall:.2f} s (loss {dlog['losses'][0][1]:.4f} "
                    f"-> {dlog['final_loss']:.4f})")
        # -- the S2S episode: re-score, lane blocks, alone vs batched --------
        bud = np.array([b * MB for b in ANSWER_MB], np.float32)
        bat = np.full(len(ANSWER_MB), float(batch), np.float32)
        out, _ = run(f"{tag} S2S batch", lambda: infer.dnnfuser_infer_batch(
            s2s, env, bat, bud, device=dev), want=0)
        wls = cm.stack_workloads([env.wl] * len(ANSWER_MB))
        re, _ = run(f"{tag} S2S re-score", lambda: cm.evaluate_grid(
            wls, out["strategy"][:, None, :], bat, bud, accel.PAPER_ACCEL),
            want=1)
        for f in ("latency", "peak_mem", "traffic"):
            a = getattr(re, f)[:, 0].cpu().numpy()
            b = out[f].cpu().numpy()
            check(np.isfinite(b).all() and np.allclose(a, b, rtol=1e-5,
                                                       atol=0),
                  f"{tag} S2S {f} differs from the kernel re-score")
        check(torch.equal(re.valid[:, 0], out["valid"]) and
              torch.equal(re.n_groups[:, 0], out["n_groups"]),
              f"{tag} S2S valid / n_groups differ from the kernel re-score")
        keys = ("strategy", "latency", "peak_mem", "speedup", "valid")
        for i in range(len(ANSWER_MB)):
            alone = infer.dnnfuser_infer_batch(s2s, env, bat[i:i + 1],
                                               bud[i:i + 1], device=dev)
            check(all(torch.equal(alone[k][0], out[k][i]) for k in keys),
                  f"{tag} S2S at {ANSWER_MB[i]} MB: alone differs from the "
                  f"batch of {len(ANSWER_MB)}")
        i = ANSWER_MB.index(int(budget_mb))
        check(np.array_equal(one_shot["Seq2Seq"].strategy,
                             out["strategy"][i].cpu().numpy()),
              f"{tag} S2S one shot differs from its batched answer")
        if ci == 0:
            short = train.TrainConfig(steps=20, batch_size=SEQ_BATCH, seed=1,
                                      log_every=5)
            twice = [dtm.param_tree(train.train_model(
                sq.s2s_loss, sq.s2s_init(scfg, seed=1, device=dev), data,
                short, device=dev)[0]) for _ in range(2)]
            check(all(torch.equal(twice[0][k], twice[1][k])
                      for k in twice[0]),
                  "two S2S trainings of one seed differ on the card")
    table_wall = time.perf_counter() - t_phase
    print(f"[16/25] Table 1 on VGG16 (PAPER_ACCEL, nmax {TABLE1_NMAX}; "
          f"baselines at {TABLE1_SAMPLES} samples, pop {BASELINE_POP}, seed 0"
          f"; A2C {A2C_EPISODES} episodes; sequence models trained "
          f"{SEQ_STEPS} steps on {TRAIN_MB} MB, one shot by the fused "
          f"episode): wall {table_wall:.1f} s")
    for line in rows:
        print(line)
    print(f"      gates held: each baseline's run on the card == its CPU run "
          f"(strategy, latency, peak), {per_run} fusion_eval launches each "
          f"({TABLE1_SAMPLES // BASELINE_POP} generations + the best); A2C "
          f"{A2C_EPISODES} x ({steps} steps + reset) + 1 launches, two runs "
          f"of one seed equal; two S2S trainings of 20 steps bit-identical; "
          f"S2S answers at {ANSWER_MB} MB == a fusion_eval re-score (rtol "
          f"1e-5, valid and n_groups equal) and bit-identical alone and "
          f"batched (128-lane blocks)")

    # -- (b) the exact optimum --------------------------------------------
    t0 = time.perf_counter()
    parts = [accel.ACCEL_ZOO[p] for p, _ in OPT_CELLS]
    nets = [tiny_cnn() for _ in OPT_CELLS]
    obud = np.array([b * MB for _, b in OPT_CELLS], np.float32)
    obat = np.full(len(OPT_CELLS), float(BATCH), np.float32)
    grid, _ = run("optimal_grid", lambda: optimal.optimal_grid(
        nets, parts, obat, obud, nmax=NMAX, device=dev), want=1)
    check(all(r.valid and r.certified is not None for r in grid),
          "optimal_grid: a cell is infeasible or uncertified")
    for c, (r, (p, b)) in enumerate(zip(grid, OPT_CELLS)):
        env = env_.FusionEnv(nets[c], parts[c], BATCH, float(obud[c]),
                             nmax=NMAX, device=dev)
        m, _ = run(f"optimal_mapping {p} {b} MB",
                   lambda: optimal.optimal_mapping(env), want=1)
        check(np.array_equal(m.strategy, r.strategy) and
              m.latency == r.latency and m.certified is not None,
              f"optimal_mapping {p} {b} MB differs from optimal_grid")
        print(f"      optimum tiny_cnn {p:10s} {b:3.0f} MB: latency "
              f"{r.latency:.9e} s, front {r.n_states}, evaluations "
              f"{r.n_evals}, host wall {r.wall_s:.4f} s (grid) / "
              f"{m.wall_s:.4f} s (optimal_mapping + certification), "
              f"certified f32 latency {float(r.certified.latency):.9e}")
    opt_lat = np.array([r.latency for r in grid])
    packed = cm.stack_workloads([cm.pack_workload(w, h, NMAX, device=dev)
                                 for w, h in zip(nets, parts)])
    base_lat = cm.baseline_grid(packed, obat, parts).latency.cpu().numpy()
    ga = gs.GSamplerConfig()
    gres, _ = run("G-Sampler over the optimum's cells",
                  lambda: gs.gsampler_search_grid(
                      nets, parts, obat, obud, nmax=NMAX, cfg=ga, top_k=1,
                      packed=packed, device=dev),
                  want=18 + ga.generations * (1 + ga.repair_tries) + 1)
    gap = gres.latency[:, 0] / opt_lat
    check(gres.valid[:, 0].all() and (gap >= 1 - 1e-5).all(),
          f"the G-Sampler beat the certified optimum: gaps {gap}")
    # the optimal-teacher corpus, against a replay of its steps
    kw = dict(batch=BATCH, max_steps=NMAX, top_k=8, seed=0,
              augment_jitter=2, teacher="optimal", device=dev)
    groups = [(["edge", "nano"], [2.0, 6.0]), (["datacenter"], [6.0])]
    n_rows = 0
    for names, budgets in groups:
        cells = [OPT_CELLS.index((p, b)) for p in names for b in budgets]
        corpus, _ = run(f"optimal corpus {names}",
                        lambda: ds_.generate_teacher_corpus(
                            [tiny_cnn()], [accel.ACCEL_ZOO[p] for p in names],
                            budgets_mb=budgets, **kw), want=0)
        elites = np.stack([grid[c].strategy for c in cells])[:, None, :]
        n_of = np.array([nets[c].n for c in cells])
        cand = ds_._augment_candidates(np.random.default_rng(0), elites,
                                       n_of, BATCH, 8, 2)
        sub = {k: v[cells] for k, v in packed.items()}
        st, rtg, ac, _, fin = ds_._decorate_grid(
            sub, cand, obat[cells], obud[cells], [parts[c] for c in cells])
        kept = _kept_rows(cand, fin.valid.cpu().numpy(), n_of)
        st, rtg, ac = (x.cpu().numpy() for x in (st, rtg, ac))
        check(len(kept) == len(corpus) and all(
            np.array_equal(np.stack([x[c, k] for c, k in kept]), y)
            for x, y in ((st, corpus.states), (rtg, corpus.rtg),
                         (ac, corpus.actions))),
              f"optimal corpus {names}: a replay keeps other rows")
        for c in cells:
            best = max(mt[2] for mt in corpus.meta
                       if mt[1] == OPT_CELLS[c][1]
                       and mt[3] == OPT_CELLS[c][0])
            want = base_lat[c] / opt_lat[c]
            check(abs(best - want) <= 1e-5 * want,
                  f"optimal corpus {OPT_CELLS[c]}: best row {best} is not "
                  f"the optimum's speedup {want}")
        n_rows += len(corpus)
    # phase 6's trained DT on these unseen cells (informative)
    out, _ = run("trained DT on the optimum's cells",
                 lambda: infer.dnnfuser_infer_batch(
                     trained, packed, obat, obud, parts, device=dev), want=0)
    dv = out["valid"].cpu().numpy()
    dgap = out["latency"].cpu().numpy() / opt_lat
    print(f"      optimal_grid certified {len(grid)} cells in 1 fusion_eval "
          f"launch; optimal_mapping 1 launch a cell, same strategies and "
          f"latencies; G-Sampler (pop {ga.population} x {ga.generations}) "
          f"gaps " + ", ".join(f"{x:.6f}" for x in gap) + " (all >= 1 - "
          f"1e-5); optimal corpus: {n_rows} rows == a replay's, each "
          f"condition's best row the optimum (0 fusion_eval launches: DP on "
          f"the host, decoration by prefix_scan); phase 6's trained DT "
          f"(informative): valid " + ", ".join(str(bool(v)) for v in dv) +
          ", gaps " + ", ".join(f"{x:.4f}" for x in dgap) +
          f"; wall {time.perf_counter() - t0:.2f} s")
    print(f"      phase 16 fusion_eval launches {total[0]}")
    return total[0]



def family_config(arch: str):
    """``arch``'s full-width config, cut to DEPTH layers where one card
    cannot hold it whole."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=DEPTH[arch]) if arch in DEPTH \
        else cfg


def family_batch(cfg, B: int, S: int, dev, *, grid: int = 0) -> dict:
    """A scoring batch from a seeded numpy stream: tokens, or embeddings
    for an ``embed_inputs`` config (with an M-RoPE grid: the first
    ``grid``^2 positions an image of grid x grid patches, then text
    positions after its largest id)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(1)
    if not cfg.embed_inputs:
        return {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (B, S)), device=dev)}
    e = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    batch = {"embeds": torch.as_tensor(e, device=dev).to(torch.bfloat16)}
    if grid:
        n = grid * grid
        thw = np.zeros((3, S), np.int64)
        thw[1, :n], thw[2, :n] = np.divmod(np.arange(n), grid)
        thw[:, n:] = np.arange(S - n) + grid
        batch["pos_thw"] = torch.as_tensor(
            np.broadcast_to(thw[:, None], (3, B, S)).copy(), device=dev)
    return batch


def scoring(dev, arch: str, phase: int, B: int = SCORE_B, S: int = SCORE_S,
            *, repeat: bool = False, grid: int = 0, probe=None,
            **want) -> dict:
    """Phases 9, 13 and 17-20: ``arch`` (bf16, seeded random weights, cut
    in depth by DEPTH) scores a B x S batch; the launches are ``want``.  With
    ``repeat`` a second identical run must give bit-identical logits.
    ``probe(model, batch)`` runs after, its text printed."""
    import torch
    from repro_torch.models import get_model
    cfg = family_config(arch)
    mod = get_model(cfg)
    t0 = time.perf_counter()
    model = mod.init(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch = family_batch(cfg, B, S, dev, grid=grid)
    warm = {k: (v[:, :, :128] if k == "pos_thw" else v[:, :128])
            for k, v in batch.items()}
    mod.forward(model, warm)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = mod.forward(model, batch)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    n = counts()
    expect_counts(f"scoring {arch}", n, **want)
    check(tuple(logits.shape) == (B, S, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), f"scoring {arch}: logits "
          "malformed or not finite")
    if arch == ARCH:                     # held by phase 24's ranks
        REF["logits " + arch] = logits[:, -TAIL:].float().cpu()
    note = ""
    if cfg.n_experts:
        aux = float(mod.forward_aux(model, batch)[1])
        check(aux == aux and aux > 0, f"{arch}: aux loss {aux}")
        note += f", aux loss {aux:.6g}"
    if repeat:
        t0 = time.perf_counter()
        again = mod.forward(model, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(torch.equal(logits, again), f"scoring {arch}: a second "
              "identical run gave other logits")
        note += "; a second run bit-identical"
        del again
    if probe is not None:
        note += "; " + probe(model, batch)
    print(f"[{phase}/25] scoring {arch} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {n_params / 1e9:.3f}e9 params, bf16, seeded "
          f"random weights; init {t_init:.2f} s) over {B}x{S}"
          f"{' embeds' if cfg.embed_inputs else ' tokens'}"
          f"{f' ({grid}x{grid} image grid in pos_thw)' if grid else ''}: "
          f"wall " + " / ".join(f"{w:.4f}" for w in walls) + f" s, launches "
          f"{launched(n)}, logits {tuple(logits.shape)} finite{note}")
    if arch == MOE:                      # phase 24's bf16 routing
        with routes() as seen:
            mod.forward(model, batch)
        REF["routes16 " + arch] = seen
    if arch == ARCH:                     # phase 24's f32 witness: the
        model.float()                    # same (bf16) weights in f32
        REF["logits32 " + arch] = mod.forward(model, batch)[:, -TAIL:].cpu()
        err = float((REF["logits " + arch] - REF["logits32 " + arch])
                    .abs().max())
        print(f"      {arch}: the same weights in f32: the bf16 logits' last"
              f" {TAIL} positions within {err:.4g} of the f32 forward's "
              f"(max |logit| {float(REF['logits32 ' + arch].abs().max()):.4g})")
    del model, logits, batch
    torch.cuda.empty_cache()
    return {"launches": n, "wall_s": walls}


def expert_loads(model, batch) -> str:
    """Tokens per expert and the dropped share, per MoE layer, recorded
    from the routing of one forward."""
    import torch
    from repro_torch.models import lm
    from repro_torch.nn import moe as tmoe
    seen, route = [], tmoe.moe_route

    def spy(*a, **kw):
        r = route(*a, **kw)
        seen.append((r.count.sum(0), float(r.keep.float().mean()), r.C))
        return r

    tmoe.moe_route = spy
    try:
        lm.forward(model, batch)
        torch.cuda.synchronize()
    finally:
        tmoe.moe_route = route
    return "expert loads " + "; ".join(
        f"layer {i}: tokens an expert min {int(c.min())} / mean "
        f"{float(c.float().mean()):.1f} / max {int(c.max())}, capacity {C} "
        f"a row, dropped {1 - keep:.4f}"
        for i, (c, keep, C) in enumerate(seen))


@contextlib.contextmanager
def routes():
    """Within the block ``moe_route`` appends each MoE layer's routing to
    the list it yields: the expert ids [B, S, k], the kept mask [B, S*k]
    (in the routing's sorted order) and each token's top-k margin, its
    k-th router probability less its (k+1)-th."""
    import torch
    from repro_torch.nn import moe as tmoe
    route, seen = tmoe.moe_route, []

    def spy(p, x, *, top_k, **kw):
        r = route(p, x, top_k=top_k, **kw)
        probs = torch.softmax(x.float() @ p.router.w.float(), dim=-1)
        top = torch.topk(probs, top_k + 1, dim=-1).values
        seen.append((r.idx.cpu(), r.keep.cpu(),
                     (top[..., top_k - 1] - top[..., top_k]).cpu()))
        return r

    tmoe.moe_route = spy
    try:
        yield seen
    finally:
        tmoe.moe_route = route


def _kept_pairs(idx, keep) -> set:
    """The kept (token, expert) pairs of a routing (``routes``), as
    ``token << 20 | expert`` keys, the token counted over the batch."""
    import torch
    B, S, k = idx.shape
    flat = idx.reshape(B, S * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    tok = torch.arange(B)[:, None] * S + torch.div(order, k,
                                                     rounding_mode="floor")
    return set(((tok << 20) | flat.gather(1, order))[keep].tolist())


def route_diff(got: list, want: list) -> list:
    """Per MoE layer, a routing against ``want``'s (``routes``): the
    tokens whose chosen experts differ, those of them that differ for
    the first time (in no layer before), the kept pairs held by one side
    only, the kept pairs, and ``want``'s top-k margins: of the tokens that
    differ first here the largest and the median, each with the share of
    all tokens at or below it, and the median of all."""
    out, before = [], None
    for (gi, gk, _), (wi, wk, wm) in zip(got, want, strict=True):
        flip = (gi.sort(-1).values != wi.sort(-1).values).any(-1)
        first = flip if before is None else flip & ~before
        before = flip if before is None else flip | before
        a, b = _kept_pairs(gi, gk), _kept_pairs(wi, wk)
        share = lambda m: float((wm <= m).float().mean())
        top = mid = None
        if first.any():
            top, mid = float(wm[first].max()), float(wm[first].median())
        out.append(dict(flipped=int(flip.sum()), first=int(first.sum()),
                        kept_diff=len(a ^ b), kept=len(b), margin=top,
                        margin_share=None if top is None else share(top),
                        mid_margin=mid,
                        mid_share=None if mid is None else share(mid),
                        median_margin=float(wm.median())))
    return out


def scan_share(model, batch) -> str:
    """The selective SSM's share of a forward's wall: one forward with a
    synchronise around each layer's SSM (its per-position Python loop)."""
    import torch
    from repro_torch.models import hymba
    from repro_torch.nn.ssm import SSM
    fwd, spent = SSM.forward, []

    def timed(self, x, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fwd(self, x, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    SSM.forward = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hymba.forward(model, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        SSM.forward = fwd
    steps = batch["tokens"].shape[1] * len(spent)
    return (f"SSM scan loop {sum(spent):.4f} s of a {wall:.4f} s forward "
            f"({sum(spent) / wall:.3f}; {len(spent)} layers x "
            f"{batch['tokens'].shape[1]} positions, "
            f"{sum(spent) / steps * 1e6:.2f} us a position and layer)")


def serving(dev, arch: str, phase: int, *, prompt: int = PROMPT,
            gen: int = NEW_GEN, impl: str = "kernel", label: str = "",
            **want) -> dict:
    """Phases 10, 14, 17 and 19-21: ``serve_greedy`` of ``arch`` (cut by
    DEPTH) in f32, batch SERVE_B, ``gen`` tokens; the launches are
    ``want``."""
    import torch
    from repro_torch.launch import serve_greedy
    cfg = family_config(arch)
    reset_counts()
    t0 = time.perf_counter()
    out = serve_greedy(cfg, batch=SERVE_B, prompt_len=prompt, gen_len=gen,
                       seed=0, impl=impl, device=dev, keep_logits=True)
    wall = time.perf_counter() - t0
    n = counts()
    expect_counts(f"serving {arch}{label}", n, **want)
    toks = out["tokens"]
    check(toks.shape == (SERVE_B, gen) and (toks >= 0).all()
          and (toks < cfg.vocab_padded).all()
          and bool(torch.isfinite(out["logits"]).all()),
          f"served {arch} tokens or logits malformed")
    shapes = ", ".join(f"{k} {tuple(v.shape)}"
                       for k, v in out["inputs"].items())
    print(f"[{phase}/25] serving {arch}{label} ({cfg.n_layers} layers) f32, "
          f"impl {impl}, batch {SERVE_B}, prefill {shapes}, gen {gen}: "
          f"prefill {out['t_prefill_s']:.4f} s, decode "
          f"{out['t_decode_s']:.4f} s, {out['tok_per_s']:.2f} tok/s; wall "
          f"with init {wall:.2f} s; launches {launched(n)}")
    out["launches"] = n
    torch.cuda.empty_cache()
    return out


def logits_held(label: str, got, want, tokens) -> str:
    """``got`` (served) within SELF_CHECK_REL of ``want``'s largest
    magnitude, and the served ``tokens`` equal ``want``'s argmax but at
    near-ties (top-2 gap within twice the error)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= SELF_CHECK_REL * scale, f"{label}: logits differ by {err} "
          f"(limit {SELF_CHECK_REL} x {scale})")
    arg = want.argmax(-1).cpu().numpy()
    top2 = want.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    diff = arg != tokens
    ties = int((diff & (gap <= 2 * err)).sum())
    check(int(diff.sum()) == ties, f"{label}: {int(diff.sum()) - ties} "
          f"greedy tokens differ beyond a near-tie")
    first = float((got[:, 0] - want[:, 0]).abs().max())
    return (f"max abs err {err:.4g} ({first:.4g} at the prefill's row) vs "
            f"max |logit| {scale:.4g} (limit {SELF_CHECK_REL} relative), "
            f"tokens equal but {ties} near-ties (top-2 gap <= 2 x err)")


def lm_search(name: str, device) -> dict:
    """``name``'s prefill chain (``lm_workload``, seq 4096, batch 32)
    searched by the host G-Sampler at MAP_BUDGET_MB and nmax MAP_NMAX on
    ``device``: the result, the ``fusion_eval`` launches and the wall."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import accel, env, gsampler as gs
    from repro_torch.kernels import fusion_eval as fe
    from repro_torch.workloads import lm_workload
    if str(device) == "cpu":            # a worker process of its own
        torch.set_num_threads(1)
    wl = lm_workload(get_config(name), seq_len=4096, batch=32,
                     mode="prefill")
    fe.reset_launches()
    t0 = time.perf_counter()
    res = gs.gsampler_search(env.FusionEnv(
        wl, accel.PAPER_ACCEL, 32, MAP_BUDGET_MB * MB, nmax=MAP_NMAX,
        device=device))
    return {"res": res, "blocks": wl.n, "launches": fe.STATS.launches,
            "wall": time.perf_counter() - t0}


def lm_mapping(dev, phase: int, cpu_jobs: dict) -> int:
    """Phase 21b: each of the ten archs' prefill chains searched by the
    host G-Sampler on the card (every evaluation one ``fusion_eval``
    launch) equals the same search on the CPU (``cpu_jobs``: name ->
    future of ``lm_search(name, "cpu")``, run in worker processes):
    strategies, elites, speedups and peaks bit-equal.  Returns the card's
    launches."""
    import numpy as np
    import torch
    from repro_torch.core import gsampler as gs
    from repro_torch.kernels import _build, fusion_eval as fe
    total, rows = 0, []
    for name, job in cpu_jobs.items():
        reset_counts()
        card = lm_search(name, dev)
        n = counts()
        expect_counts(f"lm_mapping {name}", n,
                      fusion_eval=card["launches"])
        cpu = job.result()
        a, b = card["res"], cpu["res"]
        check(card["launches"] > 0 and cpu["launches"] == 0,
              f"lm_mapping {name}: launches card {card['launches']}, CPU "
              f"{cpu['launches']}")
        check(np.array_equal(a.strategy, b.strategy)
              and len(a.elites) == len(b.elites)
              and all(np.array_equal(x, y) for x, y in zip(a.elites,
                                                            b.elites))
              and (a.speedup, a.peak_mem, a.valid, a.n_evals) ==
              (b.speedup, b.peak_mem, b.valid, b.n_evals),
              f"lm_mapping {name}: the card's search differs from the CPU's")
        total += card["launches"]
        rows.append(f"{name} {card['blocks']} blocks: speedup "
                    f"{a.speedup:.6f} (valid {a.valid}, usage "
                    f"{a.peak_mem / MB:.2f} MB, {a.n_evals} evaluations), "
                    f"{card['launches']} launches; card {card['wall']:.3f} "
                    f"s, CPU {cpu['wall']:.3f} s (one thread)")
    torch.cuda.synchronize()
    pop = gs.GSamplerConfig().population
    tile = fe.tile_for(1, pop, MAP_NMAX, _build.sm_count(
        torch.cuda.current_device()))
    print(f"[{phase}/25] LM mapping: lm_workload(seq 4096, batch 32, "
          f"prefill) of the ten archs, host gsampler_search (pop {pop}) at "
          f"{MAP_BUDGET_MB:g} MB, nmax {MAP_NMAX}, PAPER_ACCEL, through "
          f"fusion_eval (tile {tile}), each equal to the same search on the "
          f"CPU (strategy, elites, speedup and peak bit-equal):")
    for r in rows:
        print(f"      {r}")
    return total


def whisper_and_mapping(dev, cpu_jobs: dict) -> dict:
    """Phase 21: whisper_base served and self-checked, then the LM mapping;
    returns each part's launches."""
    from repro_torch.configs import get_config
    wh = get_config(WHISPER)
    Le, Ld = wh.encoder_layers, wh.n_layers
    fa_w = Le + Ld + Ld * (NEW_GEN - 1)  # encoder, prefill's and steps' xattn
    served = serving(dev, WHISPER, 21, prompt=WHISPER_T,
                            flash_attention=fa_w, fa_tensor_core_tf32x3=fa_w,
                            flash_decode=Ld * (NEW_GEN - 1))
    out = {"21 serving": served["launches"]}
    out["21 self-check"] = self_check(       # encoder, decoder self
        dev, WHISPER, served, 21, flash_attention=Le + 2 * Ld,   # and xattn
        fa_tensor_core_tf32x3=Le + 2 * Ld)["launches"]
    out["21 mapping"] = {"fusion_eval": lm_mapping(dev, 21, cpu_jobs)}
    return out


TRAIN_ARCH = "gemma3_1b"        # phase 22: 1.0e9 parameters at full width
TRAIN_B, TRAIN_S = 8, 128       # launch.train.train's defaults
TRAIN_BUDGET_MB = 24.0          # ... and its activation budget
TRAIN_STEPS = 8                 # full-width steps timed
LOOP_STEPS, LOOP_CRASH = 20, 10  # the reduced loop: cadence 10 saves at 10
TRAIN_FAMILIES = (RWKV, MOE, HYMBA, WHISPER, VLM)   # one reduced step each
TRAIN_CKPT_LM = ROOT / "build" / "smoke_lm_train"
TRAIN_GRAD_TOL = 2e-4   # card vs CPU, of a leaf's largest: the CPU tests'
MOE_MEM_B, MOE_MEM_S = 8, 4096  # take_rows' memory against a plain gather


def train_bound_ms(n_params: int, tokens: int,
                   ops_per_s: float = H100_F32_OPS_PER_S) -> float:
    """6 operations a parameter and token (forward and backward) at
    ``ops_per_s``: the f32 CUDA-core rate by default (TF32 is off in the
    port), the bf16 tensor-core rate for a bf16 model; attention's S^2
    term (under 1% at S 128) is left out."""
    return 6.0 * n_params * tokens / ops_per_s * 1e3


def _grads(model, mod, batch) -> tuple:
    """``(loss, [gradient of each leaf])`` of the default ``loss_fn``."""
    import torch
    from repro_torch.core.model import param_tree
    pt = param_tree(model)
    loss = mod.loss_fn(model, batch)
    return loss.detach(), list(torch.autograd.grad(
        loss, list(pt.values()), allow_unused=True, materialize_grads=True))


def _grads_held_to_cpu(label: str, model, opt_state, batch_fn) -> str:
    """One step's gradients of the default ``loss_fn`` on the card against
    the same step on the CPU (the path the CPU tests hold to ``jax.grad``),
    from the same weights (carried to the CPU through the training
    checkpoint's conversion) and batch: each leaf within TRAIN_GRAD_TOL of
    its largest CPU gradient, the loss within the same rtol."""
    import torch
    from repro_torch.checkpoint import (lm_params_from_reference,
                                        lm_train_state_to_reference)
    from repro_torch.models import get_model
    mod = get_model(model.cfg)
    dev = next(model.parameters()).device
    loss, got = _grads(model, mod, batch_fn(model.cfg, dev))
    host = lm_params_from_reference(
        lm_train_state_to_reference(model, opt_state, 0)["params"],
        model.cfg, device="cpu")
    want_loss, want = _grads(host, mod, batch_fn(model.cfg, "cpu"))
    worst, zero = 0.0, 0
    for a, b in zip(got, want):
        a = a.cpu()
        top, err = float(b.abs().max()), float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()) and err <= TRAIN_GRAD_TOL * top,
              f"{label}: a card gradient is not finite or differs from the "
              f"CPU's by {err:.3e} (largest {top:.3e})")
        worst = max(worst, err / top if top else 0.0)
        zero += top == 0.0
    check(abs(float(loss) - float(want_loss))
          <= TRAIN_GRAD_TOL * abs(float(want_loss)),
          f"{label}: loss {float(loss)} on the card, {float(want_loss)} on "
          f"the CPU")
    return (f"gradients held to the CPU's on {len(got)} leaves (worst "
            f"{worst:.2e} of a leaf's largest, {zero} all zero on both), "
            f"loss {float(loss):.6f} vs {float(want_loss):.6f}")


def _moe_gather_memory(dev) -> str:
    """One ``loss_fn`` gradient of reduced qwen3_moe at MOE_MEM_B x
    MOE_MEM_S through ``nn.linear.take_rows`` and through a plain gather
    (``table[ids]``, whose card backward is ``index_put_``'s sorted sum):
    take_rows' peak memory within 10% of the plain gather's, the same
    loss, the gradients within TRAIN_GRAD_TOL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as lt
    from repro_torch.models import get_model
    from repro_torch.nn import linear, moe
    cfg = get_config(MOE, reduced=True)
    mod = get_model(cfg)
    model = mod.init(cfg, seed=0, dtype=torch.float32, device=dev)
    batch = lt.make_batch_fn(cfg, seq_len=MOE_MEM_S, global_batch=MOE_MEM_B,
                             device=dev)(0)
    ways = {"take_rows": linear.take_rows, "plain": lambda t, i: t[i]}
    res = {}
    for name, fn in list(ways.items()) * 2:     # the second pass is timed
        moe.take_rows = linear.take_rows = fn
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = _grads(model, mod, batch)
            torch.cuda.synchronize()
            res[name] = (out, (time.perf_counter() - t0) * 1e3,
                         torch.cuda.max_memory_allocated() - base)
        finally:
            moe.take_rows = linear.take_rows = ways["take_rows"]
    (loss, got), ms, peak = res["take_rows"]
    (ploss, want), pms, ppeak = res["plain"]
    check(peak <= 1.1 * ppeak and torch.equal(loss, ploss) and all(
        float((a - b).abs().max()) <= TRAIN_GRAD_TOL * float(b.abs().max())
        for a, b in zip(got, want)),
        f"22 MoE gather: take_rows peak {peak} B against the plain "
        f"gather's {ppeak} B, or its loss or gradients differ")
    slots = MOE_MEM_B * cfg.n_experts * moe.capacity(
        MOE_MEM_S, cfg.moe_top_k, cfg.n_experts, cfg.capacity_factor)
    return (f"reduced {MOE} at {MOE_MEM_B}x{MOE_MEM_S} (dispatch {slots} "
            f"ids a layer): one loss_fn gradient through take_rows peaks "
            f"{peak / 2**30:.3f} GiB above the weights, {ms:.2f} ms; "
            f"through a plain gather {ppeak / 2**30:.3f} GiB, {pms:.2f} ms; "
            f"same loss, gradients within {TRAIN_GRAD_TOL:g}")


def _trained_state(loop) -> list:
    from repro_torch.core.model import param_tree
    return (list(param_tree(loop.model).values())
            + list(loop.opt_state.mu.values())
            + list(loop.opt_state.nu.values()))


def lm_training(dev) -> dict:
    """Phase 22: LM training on the card.  gemma3_1b at full width: the
    mapper's micro-batch (G-Sampler on ``fusion_eval``, equal to the same
    search on the CPU), then TRAIN_STEPS steps of
    ``make_local_train_step`` at that ``grad_accum`` (no attention kernel
    launched, the loss falling, every first-step gradient finite and not
    all zero) and the time of a checkpoint's host copy; the reduced loop
    ``train`` straight through and crashed at LOOP_CRASH and restarted,
    bit-identical, its gradients held to the CPU's; one ``train`` step
    with the mapper for each other family, its gradients held to the
    CPU's; the MoE gathers' memory at seq MOE_MEM_S against a plain
    gather's.  Returns the launches of each part."""
    import shutil
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.core.model import param_tree
    from repro_torch.launch import train as lt
    from repro_torch.models import get_model
    out = {}
    cfg = get_config(TRAIN_ARCH)
    reset_counts()
    t0 = time.perf_counter()
    mapped = lt.mapper_microbatch(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B,
                                  act_budget_mb=TRAIN_BUDGET_MB, device=dev)
    map_wall = time.perf_counter() - t0
    out["22 mapper"] = n = counts()
    expect_counts("22 mapper", n, fusion_eval=n["fusion_eval"])
    t0 = time.perf_counter()
    cpu = lt.mapper_microbatch(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B,
                               act_budget_mb=TRAIN_BUDGET_MB, device="cpu")
    cpu_wall = time.perf_counter() - t0
    check(n["fusion_eval"] > 0 and np.array_equal(cpu["strategy"],
                                                  mapped["strategy"])
          and all(cpu[k] == mapped[k] for k in ("micro_batch", "grad_accum",
                                                "speedup")),
          f"22 mapper: the card's search {mapped} differs from the CPU's "
          f"{cpu}")
    ga = mapped["grad_accum"]
    print(f"[22/25] LM training: {TRAIN_ARCH} mapper (lm_workload train, "
          f"seq {TRAIN_S}, batch {TRAIN_B}, {TRAIN_BUDGET_MB:g} MB, nmax "
          f"{lt.MAPPER_NMAX}, host G-Sampler of 20 generations on "
          f"fusion_eval): micro-batch {mapped['micro_batch']}, grad_accum "
          f"{ga}, modeled speedup {mapped['speedup']:.6f}, "
          f"{n['fusion_eval']} fusion_eval launches, wall {map_wall:.3f} s "
          f"(the same search on the CPU {cpu_wall:.3f} s, equal)")

    mod = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = mod.init(cfg, seed=0, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tx = optim.adamw(optim.cosine_with_warmup(3e-4, 20, TRAIN_STEPS),
                     weight_decay=0.01, max_grad_norm=1.0)
    first = []                           # the first step's gradient norms

    def update(grads, state, params):
        if not first:
            first.extend(torch.stack(torch._foreach_norm(
                list(grads.values()))).tolist())
        return tx.update(grads, state, params)

    step = lt.make_local_train_step(
        cfg, optim.GradientTransformation(tx.init, update), grad_accum=ga)
    batch_fn = lt.make_batch_fn(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B,
                                device=dev)
    opt_state = tx.init(param_tree(model))
    reset_counts()
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        model, opt_state, loss = step(model, opt_state, batch_fn(i))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    out["22 full width"] = n = counts()
    expect_counts("22 full-width steps", n)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    ms = float(np.median(walls[1:])) * 1e3
    bound = train_bound_ms(n_params, TRAIN_B * TRAIN_S)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"22: the loss did not fall: {losses}")
    check(len(first) == len(param_tree(model)) and all(
        np.isfinite(first)) and min(first) > 0, f"22: a first-step gradient "
        f"is zero or not finite (norms {first})")
    print(f"      {TRAIN_ARCH} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {n_params / 1e9:.4f}e9 params, f32, seeded "
          f"random weights; init {t_init:.2f} s), {TRAIN_STEPS} steps of "
          f"{TRAIN_B}x{TRAIN_S} tokens at grad_accum {ga}: "
          f"{ms:.2f} ms a step (median of steps 1-{TRAIN_STEPS - 1}; step 0 "
          f"{walls[0] * 1e3:.2f} ms), bound {bound:.2f} ms (6 x params x "
          f"tokens at 67 TFLOP/s f32: {bound / ms:.3f} of it), "
          f"{TRAIN_B * TRAIN_S / ms * 1e3:.1f} tokens/s, peak "
          f"{peak / 2**30:.2f} of {total / 2**30:.2f} GiB; launches "
          f"{launched(n)}; first-step gradients finite and nonzero on all "
          f"{len(first)} leaves (norms {min(first):.3e}..{max(first):.3e}); "
          f"losses " + ", ".join(f"{x:.4f}" for x in losses))
    from repro_torch.checkpoint import lm_train_state_to_reference
    t0 = time.perf_counter()
    host = lm_train_state_to_reference(model, opt_state, TRAIN_STEPS - 1)
    t_copy = time.perf_counter() - t0
    nbytes = sum(a.nbytes for tree in (host["params"], host["opt"].mu,
                                       host["opt"].nu) for a in tree.values())
    del host
    print(f"      a TrainLoop checkpoint's synchronous part at full width "
          f"(lm_train_state_to_reference: params and both moments to the "
          f"host, stacked on the layer axis): {t_copy:.2f} s for "
          f"{nbytes / 1e9:.2f} GB; the file write runs in the background "
          f"(not timed here)")
    print(f"      {smi_line()}")
    del model, opt_state, step, loss
    torch.cuda.empty_cache()

    shutil.rmtree(TRAIN_CKPT_LM, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    kw = dict(reduced=True, steps=LOOP_STEPS, device=dev)
    straight, _ = lt.train(TRAIN_ARCH, ckpt_dir=str(TRAIN_CKPT_LM / "a"), **kw)
    try:
        lt.train(TRAIN_ARCH, ckpt_dir=str(TRAIN_CKPT_LM / "b"),
                 crash_at=LOOP_CRASH, **kw)
        crashed = False
    except RuntimeError as e:
        crashed = "simulated node failure" in str(e)
    check(crashed, "22 loop: crash_at did not stop the run")
    resumed, _ = lt.train(TRAIN_ARCH, ckpt_dir=str(TRAIN_CKPT_LM / "b"), **kw)
    loop_wall = time.perf_counter() - t0
    out["22 loop"] = n = counts()
    expect_counts("22 loop", n)
    check(resumed.start_step == LOOP_CRASH + 1 and all(
        torch.equal(a, b) for a, b in zip(_trained_state(resumed),
                                          _trained_state(straight)))
          and resumed.losses[-1] == straight.losses[-1],
          "22 loop: the restarted run is not bit-identical to the straight "
          "one")
    print(f"      reduced loop: train({TRAIN_ARCH}, reduced, {LOOP_STEPS} "
          f"steps) straight and crashed at {LOOP_CRASH} then restarted: "
          f"params and AdamW moments bit-identical, last loss "
          f"{straight.losses[-1][1]:.6f} both; median step "
          f"{straight.monitor.median * 1e3:.2f} ms; the three runs "
          f"{loop_wall:.2f} s; launches {launched(n)}")

    def batch_fn(rcfg, device):
        return lt.make_batch_fn(rcfg, seq_len=TRAIN_S, global_batch=TRAIN_B,
                                device=device)(1)
    rows = [f"{TRAIN_ARCH} (dense, the straight loop's model): "
            + _grads_held_to_cpu(f"22 {TRAIN_ARCH}", straight.model,
                                 straight.opt_state, batch_fn)]
    for arch in TRAIN_FAMILIES:
        reset_counts()
        t0 = time.perf_counter()
        loop, info = lt.train(arch, reduced=True, steps=1, use_mapper=True,
                              ckpt_dir=str(TRAIN_CKPT_LM / arch), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[f"22 {arch}"] = n = counts()
        expect_counts(f"22 {arch}", n, fusion_eval=n["fusion_eval"])
        check(n["fusion_eval"] > 0, f"22 {arch}: the mapper launched no "
              f"fusion_eval")
        held = _grads_held_to_cpu(f"22 {arch}", loop.model, loop.opt_state,
                                  batch_fn)
        rows.append(f"{arch} ({loop.model.cfg.family}): micro-batch "
                    f"{info['micro_batch']}, grad_accum {info['grad_accum']}, "
                    f"loss {loop.losses[-1][1]:.4f}, {n['fusion_eval']} "
                    f"fusion_eval launches, {wall:.2f} s; {held}")
    shutil.rmtree(TRAIN_CKPT_LM, ignore_errors=True)
    print("      the default loss_fn's gradients of step 1's batch on the "
          "card against the CPU's (one train(use_mapper=True) step a "
          "family, reduced; no attention or WKV kernel launched):")
    for r in rows:
        print(f"        {r}")
    reset_counts()
    mem = _moe_gather_memory(dev)
    expect_counts("22 MoE gather", counts())
    print(f"      {mem}")
    return out


# -- phase 23: the distributed half ------------------------------------------
TRANSFER_MB = (16, 32, 48, 64)  # the transfer example's pre-training grid
FINE_MB = (25, 45)              # ... and its MnasNet fine-tuning budgets
TRANSFER_ANSWER_MB = (25.0, 35.0, 55.0)   # ... and the conditions it answers
TRANSFER_STEPS = 300            # the example's pre-training steps
DIST_STEPS = 4                  # build_train_step steps at full width
DIST_DECODE = 8                 # tokens served through the builders
# build_train_step (FSDP2 at one rank) against make_local_train_step on
# the same batches: a loss within this share of the local step's
FSDP_LOSS_RTOL = 1e-5
# the card's peak over the dry-run's predicted one (arguments + the
# MemTracker temporaries of the step and its update), stated before the
# first run: FSDP2's gathered copies and the allocator's rounding lie on
# top of the prediction
PEAK_BAND = (0.95, 1.25)
DIST_CKPT = ROOT / "build" / "smoke_transfer_ckpt"


def _count_cpu_runs(fn):
    """``fn()`` with every ``fusion_eval`` evaluation counted (on the CPU
    each one is a call of the plain twin through ``fusion_eval._run``):
    ``(result, count)``."""
    from repro_torch.kernels import fusion_eval as fe
    n = [0]
    orig = fe._run

    def counting(form, inputs):
        n[0] += 1
        return orig(form, inputs)
    fe._run = counting
    try:
        return fn(), n[0]
    finally:
        fe._run = orig


def distributed_half(dev, phase10_tokens) -> dict:
    """Phase 23: the distributed half on a world-size-1 NCCL group (a
    ``HashStore``, no TCP port), destroyed at the end.  (a) the transfer
    path on ``data_parallel_mesh()``: the grid corpus of VGG16/ResNet18
    (``fusion_eval`` launches equal to the CPU's evaluations),
    TRANSFER_STEPS data-parallel steps bit-equal to ``mesh=None``, and
    ``fine_tune(mesh=)`` on MnasNet, bit-equal too; (b) ``MapperEngine``
    with every visible card as replicas, bit-identical to no replicas on
    phase 7's requests; (c) ``build_train_step`` at gemma3_1b full width
    (``remat="full"``) against ``make_local_train_step`` (no remat); (d) ``build_prefill`` +
    ``build_decode_step`` at qwen3_8b full width: phase 10's tokens, and
    its ``flash_decode`` launches; (e) ``dryrun.lower_cell`` on a (1, 1)
    mesh at (c)'s cell: argument bytes and FLOPs equal (c)'s real step's,
    the predicted peak beside the card's.  Returns the launches of each
    part."""
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import optim
    from repro_torch.configs import Shape, get_config
    from repro_torch.core import (accel, dataset as ds_, env as env_,
                                  gsampler as gs, infer, model as dtm, train)
    from repro_torch.distributed.sharding import data_parallel_mesh
    from repro_torch.launch import dryrun, steps, train as lt
    from repro_torch.launch.mesh import MeshSpec, init_mesh, process_group
    from repro_torch.models import get_model
    from repro_torch.serving import (MapperEngine, MapRequest, ReplicaGroup,
                                     ServingConfig)
    from repro_torch.workloads import CNN_ZOO, mnasnet_b1, resnet18, vgg16
    from repro_torch.workloads.grid import serving_stream
    out = {}
    ga = gs.GSamplerConfig()
    want_fe = 18 + ga.generations * (1 + ga.repair_tries) + 1
    t_phase = time.perf_counter()
    with process_group(dev):
        backend = "nccl" if dev.type == "cuda" else "gloo"
        check(dist.get_backend() == backend and dist.get_world_size() == 1,
              f"23: not a one-rank {backend} group")
        mesh = data_parallel_mesh(device=dev)

        # -- (a) the transfer path on the data-parallel mesh ---------------
        nets = [vgg16(), resnet18()]
        kw = dict(batch=BATCH, budgets_mb=list(TRANSFER_MB), max_steps=NMAX,
                  seed=0)
        reset_counts()
        t0 = time.perf_counter()
        corpus = ds_.generate_teacher_corpus(nets, accel.PAPER_ACCEL,
                                             device=dev, **kw)
        torch.cuda.synchronize()
        corpus_wall = time.perf_counter() - t0
        out["23 corpus"] = n = counts()
        expect_counts("23 corpus", n, fusion_eval=want_fe)
        t0 = time.perf_counter()
        cpu_corpus, cpu_evals = _count_cpu_runs(
            lambda: ds_.generate_teacher_corpus(nets, accel.PAPER_ACCEL,
                                                device="cpu", **kw))
        cpu_wall = time.perf_counter() - t0
        check(cpu_evals == n["fusion_eval"], f"23 corpus: {n['fusion_eval']}"
              f" fusion_eval launches, the CPU evaluated {cpu_evals} times")
        cfg = dtm.DTConfig(hw_dim=accel.HW_FEATURE_DIM)
        tc = train.TrainConfig(steps=TRANSFER_STEPS, batch_size=16,
                               ckpt_every=TRANSFER_STEPS // 2)
        shutil.rmtree(DIST_CKPT, ignore_errors=True)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp_model, dp_log = train.train_model(
            dtm.dt_loss, dtm.dt_init(cfg, seed=0, device=dev), corpus, tc,
            mesh=mesh, ckpt_dir=str(DIST_CKPT / "pre"), device=dev)
        torch.cuda.synchronize()
        dp_wall = time.perf_counter() - t0
        out["23 DP training"] = n = counts()
        expect_counts("23 DP training", n)
        t0 = time.perf_counter()
        plain_model, plain_log = train.train_model(
            dtm.dt_loss, dtm.dt_init(cfg, seed=0, device=dev), corpus,
            train.TrainConfig(steps=TRANSFER_STEPS, batch_size=16),
            device=dev)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        same = lambda a, b: all(torch.equal(x, y) for x, y in zip(
            dtm.param_tree(a).values(), dtm.param_tree(b).values()))
        diff = [(a, b) for a, b in zip(dp_log["losses"], plain_log["losses"])
                if a != b]
        check(not diff and same(dp_model, plain_model), f"23 DP training: "
              f"the one-rank data-parallel run differs from mesh=None "
              f"(losses {diff[:3]})")
        reset_counts()
        ft_corpus = ds_.generate_teacher_corpus(
            [mnasnet_b1()], accel.PAPER_ACCEL, batch=BATCH,
            budgets_mb=list(FINE_MB), max_steps=NMAX, seed=1, device=dev)
        ftc = train.TrainConfig(steps=TRANSFER_STEPS // 10, batch_size=16,
                                lr=1e-4, warmup=5)
        t0 = time.perf_counter()
        tuned, ft_log = train.fine_tune(
            dtm.dt_loss, str(DIST_CKPT / "pre"), ft_corpus, ftc,
            template=dtm.dt_init(cfg, seed=0, device=dev), mesh=mesh,
            device=dev)
        torch.cuda.synchronize()
        ft_wall = time.perf_counter() - t0
        plain_tuned, _ = train.fine_tune(dtm.dt_loss, plain_model, ft_corpus,
                                         ftc, device=dev)
        out["23 fine-tune"] = n = counts()
        expect_counts("23 fine-tune", n, fusion_eval=want_fe)
        check(same(tuned, plain_tuned), "23 fine-tune: the data-parallel "
              "run from the checkpoint differs from mesh=None's")
        shutil.rmtree(DIST_CKPT, ignore_errors=True)
        wl = mnasnet_b1()
        answers = []
        reset_counts()
        for mb in TRANSFER_ANSWER_MB:
            env = env_.FusionEnv(wl, accel.PAPER_ACCEL, batch=BATCH,
                                 budget_bytes=mb * MB, nmax=NMAX, device=dev)
            df = infer.dnnfuser_infer_fused(tuned, env)
            g = gs.gsampler_search(env)
            answers.append(f"{mb:g} MB {df.speedup:.4f}x "
                           f"(valid {df.valid}) vs G-Sampler "
                           f"{g.speedup:.4f}x")
        out["23 answers"] = n = counts()
        expect_counts("23 answers", n, fusion_eval=n["fusion_eval"])
        print(f"[23/25] distributed half on a one-rank {backend} group "
              f"(HashStore): (a) transfer on data_parallel_mesh(): corpus "
              f"of VGG16+ResNet18 x {TRANSFER_MB} MB, {len(corpus)} rows, "
              f"{out['23 corpus']['fusion_eval']} fusion_eval launches == "
              f"{cpu_evals} CPU evaluations ({len(cpu_corpus)} CPU rows), "
              f"{corpus_wall:.3f} s (CPU {cpu_wall:.2f} s); {TRANSFER_STEPS}"
              f" DP steps {dp_wall:.2f} s ({dp_wall / TRANSFER_STEPS * 1e3:.3f}"
              f" ms a step; mesh=None {plain_wall:.2f} s, "
              f"{plain_wall / TRANSFER_STEPS * 1e3:.3f} ms), losses and "
              f"parameters bit-equal to mesh=None, final loss "
              f"{dp_log['final_loss']:.6f}; fine_tune(mesh=) on MnasNet "
              f"{ftc.steps} steps from the rank-0 checkpoint {ft_wall:.2f} s, "
              f"bit-equal to mesh=None's, loss {ft_log['final_loss']:.6f}; "
              f"answers (informative): " + "; ".join(answers))

        # -- (b) engine replicas on phase 7's requests ---------------------
        zoo = accel.ACCEL_ZOO
        cnn = {k: CNN_ZOO[k]() for k in sorted(CNN_ZOO)}
        conds, _ = serving_stream(sorted(zoo), STREAM_N, seed=0)
        reqs = [MapRequest(cnn[c[0]], c[3], c[2] * MB, zoo[c[1]])
                for c in conds]
        group = ReplicaGroup() if dev.type == "cuda" \
            else ReplicaGroup(devices=[dev])      # a CPU rehearsal
        reset_counts()
        t0 = time.perf_counter()
        base = MapperEngine(tuned, device=dev).serve(reqs)
        torch.cuda.synchronize()
        base_wall = time.perf_counter() - t0
        eng = MapperEngine(tuned, device=dev,
                           config=ServingConfig(replicas=group))
        t0 = time.perf_counter()
        got = eng.serve(reqs)
        torch.cuda.synchronize()
        rep_wall = time.perf_counter() - t0
        out["23 replicas"] = n = counts()
        expect_counts("23 replicas", n)
        bad = sum(not _same_response(a, b) for a, b in zip(got, base))
        check(bad == 0, f"23 replicas: {bad} of {len(reqs)} responses "
              f"differ from the engine without replicas")
        rs = eng.stats()["replicas"]
        check(rs["sharded_calls"] > 0 and sum(rs["rows_per_replica"]) > 0,
              f"23 replicas: no sharded call ({rs})")
        print(f"      (b) MapperEngine(replicas=ReplicaGroup(): "
              f"{group.n} of {torch.cuda.device_count()} visible cards) on "
              f"phase 7's {len(reqs)} requests with (a)'s fine-tuned DT: "
              f"every response bit-identical to replicas=None; "
              f"{rs['sharded_calls']} sharded calls, rows per replica "
              f"{rs['rows_per_replica']}; {rep_wall:.3f} s (no replicas "
              f"{base_wall:.3f} s)")
        del dp_model, plain_model, tuned, plain_tuned, eng
        torch.cuda.empty_cache()

        # -- (c) build_train_step at full width ----------------------------
        gcfg = get_config(TRAIN_ARCH)
        mod = get_model(gcfg)
        tx = optim.adamw(3e-4, weight_decay=0.01, max_grad_norm=1.0)
        bf = lt.make_batch_fn(gcfg, seq_len=TRAIN_S, global_batch=TRAIN_B,
                              device=dev)
        batches = [{k: v.to(torch.int32) for k, v in bf(i).items()}
                   for i in range(DIST_STEPS)]
        model = mod.init(gcfg, seed=0, dtype=torch.float32, device=dev)
        local = lt.make_local_train_step(gcfg, tx)
        opt = tx.init(dtm.param_tree(model))
        want = []
        for b in batches:
            model, opt, loss = local(model, opt, b)
            want.append(float(loss))
        REF["train losses"] = want                   # held by phase 24
        del model, opt, local, loss
        torch.cuda.empty_cache()
        cell = Shape("smoke", TRAIN_S, TRAIN_B, "train")
        tmesh = init_mesh((1, 1), ("data", "model"), dev.type)
        step, _ = steps.build_train_step(gcfg, cell, tmesh,
                                         dtype=torch.float32)
        torch.cuda.reset_peak_memory_stats()
        model = step.place(mod.init(gcfg, seed=0, dtype=torch.float32,
                                    device=dev))
        opt = step.init_opt(model)
        reset_counts()
        losses, walls = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt, loss = step(model, opt, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss))
        out["23 build_train_step"] = n = counts()
        expect_counts("23 build_train_step", n)
        peak = torch.cuda.max_memory_allocated()
        check(all(abs(g - w) <= FSDP_LOSS_RTOL * abs(w)
                  for g, w in zip(losses, want)),
              f"23 build_train_step: losses {losses}, make_local_train_step"
              f" {want}")
        with FlopCounterMode(display=False) as fc:
            model, opt, _ = step(model, opt, batches[0])
        real_flops = float(fc.get_total_flops())
        real_args = (sum(t.numel() * t.element_size()
                         for t in step.local_tree(model).values())
                     + sum(t.numel() * t.element_size()
                           for tree in (opt.mu, opt.nu)
                           for t in tree.values())
                     + sum(t.numel() * t.element_size()
                           for t in batches[0].values()))
        ms = float(np.median(walls[1:])) * 1e3
        bound = train_bound_ms(sum(p.numel() for p in model.parameters()),
                               TRAIN_B * TRAIN_S)
        print(f"      (c) build_train_step({TRAIN_ARCH} full width, f32, "
              f"{TRAIN_B}x{TRAIN_S}, remat full) on a (data 1, model 1) "
              f"mesh, FSDP2 "
              f"over 'data': {ms:.2f} ms a step (median of steps 1-"
              f"{DIST_STEPS - 1}; step 0 {walls[0] * 1e3:.2f} ms), bound "
              f"{bound:.2f} ms, peak {peak / 2**30:.2f} GiB; losses "
              + ", ".join(f"{x:.6f}" for x in losses) + " vs "
              "make_local_train_step's " + ", ".join(f"{x:.6f}" for x in want)
              + f" (max rel diff {max(abs(g - w) / abs(w) for g, w in zip(losses, want)):.3e}"
              f", tolerance {FSDP_LOSS_RTOL:g}); launches {launched(n)}")
        del model, opt, step, loss
        torch.cuda.empty_cache()

        # -- (e) the dry-run against (c) -----------------------------------
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(None, None, mesh=MeshSpec((1, 1), (
            "data", "model")), cfg=gcfg, shape=cell, dtype=torch.float32)
        dry_wall = time.perf_counter() - t0
        mem = rec["memory"]
        check(mem["argument_size_in_bytes"] == real_args, f"23 dry-run: "
              f"argument bytes {mem['argument_size_in_bytes']}, the real "
              f"step's {real_args}")
        check(rec["flops_total"] == real_flops == rec["flops_per_device"],
              f"23 dry-run: FLOPs {rec['flops_total']}, FlopCounterMode on "
              f"the real step {real_flops}")
        ratio = peak / mem["peak_size_in_bytes"]
        print(f"      (e) dryrun.lower_cell on a (1, 1) MeshSpec at (c)'s "
              f"cell ({dry_wall:.2f} s on the host): argument bytes "
              f"{mem['argument_size_in_bytes']} == the real step's, FLOPs "
              f"{rec['flops_total']:.6e} == FlopCounterMode on the real "
              f"step; predicted peak {mem['peak_size_in_bytes'] / 2**30:.2f}"
              f" GiB (temporaries {mem['temp_size_in_bytes'] / 2**30:.2f}), "
              f"the card's {peak / 2**30:.2f} GiB: ratio {ratio:.4f}, "
              f"{'within' if PEAK_BAND[0] <= ratio <= PEAK_BAND[1] else 'OUTSIDE'}"
              f" the band {PEAK_BAND}; roofline (datasheet, prediction): "
              f"compute {rec['roofline']['t_compute'] * 1e3:.2f} ms, memory "
              f"{rec['roofline']['t_memory'] * 1e3:.2f} ms -> "
              f"{rec['roofline']['bottleneck']}")

        # -- (d) prefill + decode through the builders ---------------------
        qcfg = family_config(ARCH)
        qshape = Shape("smoke", PROMPT + GEN + 8, SERVE_B, "decode")
        prefill, _ = steps.build_prefill(qcfg, qshape, tmesh,
                                         dtype=torch.float32)
        decode, _ = steps.build_decode_step(qcfg, qshape, tmesh,
                                            dtype=torch.float32)
        t0 = time.perf_counter()
        model = prefill.place(get_model(qcfg).init(
            qcfg, seed=0, dtype=torch.float32, device=dev))
        decode.place(model)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        prompt = np.random.default_rng(0).integers(0, qcfg.vocab,
                                                   (SERVE_B, PROMPT))
        reset_counts()
        t0 = time.perf_counter()
        logits, state = prefill(model, {"tokens": torch.as_tensor(
            prompt, device=dev)})
        tok = logits[:, -1].argmax(-1)[:, None]
        toks = [tok]
        for _ in range(DIST_DECODE - 1):
            tok, state = decode(model, state, {"tokens": tok})
            toks.append(tok)
        got = torch.cat([t.long() for t in toks], 1).cpu().numpy()
        serve_wall = time.perf_counter() - t0
        out["23 builders serving"] = n = counts()
        L = qcfg.n_layers
        expect_counts("23 builders serving", n,
                      flash_decode=L * (DIST_DECODE - 1))
        check(np.array_equal(got, phase10_tokens[:, :DIST_DECODE]),
              f"23 builders: tokens {got.tolist()} differ from phase 10's "
              f"{phase10_tokens[:, :DIST_DECODE].tolist()}")
        print(f"      (d) build_prefill + build_decode_step({ARCH} full "
              f"width, f32, batch {SERVE_B}, prompt {PROMPT}, cache "
              f"{qshape.seq_len}) on the (1, 1) mesh: {DIST_DECODE} tokens "
              f"== phase 10's serve_greedy's, {serve_wall:.3f} s (place "
              f"{t_init:.2f} s); launches {launched(n)}")
        del model, state, logits, prefill, decode
        torch.cuda.empty_cache()
    check(not dist.is_initialized(), "23: the process group outlived the "
          "phase")
    print(f"      phase 23 {time.perf_counter() - t_phase:.1f} s")
    return out



# -- phase 24: the LMs on the 'model' axis -----------------------------------
TP = 2                          # phase 24's 'model' axis
TP_DIR = ROOT / "build" / "smoke_tp"
TAIL = 8                        # the scoring logits' last positions held
BF16_OVER_ROUND = 1.4           # (b): bf16 scoring logits, TP vs one card,
                                # at most this times phase 9's own bf16
                                # rounding (its bf16 logits against its f32
                                # forward of the same weights), each of the
                                # largest |logit|; read 1.233, the control
                                # 1.610 (PERF.md, phase 24)
COARSE_BITS = 2                 # (b)'s control: its 'model' sums' coarsening
TP_LOSS_RTOL = 1e-5
TP_F32_REL = 1e-4               # f32 logits, TP vs one card, of the largest
REF: dict = {}                  # one card's results that phase 24 holds
                                # its ranks to (phases 9, 10, 14, 17, 23)


def tp_route() -> str:
    """How phase 24's ranks run, chosen by the machine: NCCL with one card
    a rank where there are TP cards, else gloo with both ranks on the one
    card (the installed PyTorch's gloo takes the steps' collectives on
    CUDA tensors: all_reduce, all_gather_into_tensor, reduce_scatter_tensor
    and all_to_all_single; NCCL refuses two ranks on one device)."""
    import torch
    return "nccl" if torch.cuda.device_count() >= TP else "gloo"


def _tp_serving(dev, mesh, rank, arch, n_decode, ref_tokens) -> dict:
    """(a) and (c): ``build_prefill`` + ``build_decode_step`` of ``arch``
    (full width, f32, built as this rank's shard of the seed-0 draw)
    serving serve_greedy's prompt; the tokens and launches."""
    import numpy as np
    import torch
    from repro_torch.configs import Shape
    from repro_torch.distributed import tp
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    cfg = family_config(arch)
    shape = Shape("smoke", PROMPT + GEN + 8, SERVE_B, "decode")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = get_model(cfg).init(cfg, seed=0, dtype=torch.float32, device=dev,
                                shard=tp.Keep.of(cfg, rank, TP))
    prefill, _ = steps.build_prefill(cfg, shape, mesh, dtype=torch.float32)
    decode, _ = steps.build_decode_step(cfg, shape, mesh, dtype=torch.float32)
    prefill.place(model)
    decode.place(model)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    prompt = np.random.default_rng(0).integers(0, cfg.vocab,
                                               (SERVE_B, PROMPT))
    reset_counts()
    t0 = time.perf_counter()
    logits, state = prefill(model, {"tokens": torch.as_tensor(
        prompt, device=dev)})
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    toks = [tok]
    for _ in range(n_decode - 1):
        tok, state = decode(model, state, {"tokens": tok})
        toks.append(tok)
    got = torch.cat([t.long() for t in toks], 1).cpu().numpy()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held = state["k"].shape[2] if "k" in state else None
    return dict(tokens=got, equal=bool(np.array_equal(got, ref_tokens)),
                launches=counts(), wall_s=wall, prefill_s=t_pre,
                init_s=t_init, peak=torch.cuda.max_memory_allocated(dev),
                cache_positions=held, moved_prefill=dict(prefill.par.moved),
                moved_decode=dict(decode.par.moved))


def _tp_scoring(dev, mesh, rank, arch, ref_logits, *, dtype, cast=None,
                batch=None, routing=None, coarse=0) -> dict:
    """(b), (d) and their witnesses: ``arch`` (``dtype``, this rank's
    shard of the seed-0 draw, then cast to ``cast``) scores ``batch``
    (default phase 9's) through a ``Placement``; the logits' last TAIL
    positions against one card's ``ref_logits``, the launches, and with
    ``routing`` the MoE layers' routing against one card's
    (``route_diff``).  ``coarse`` > 0 is (b)'s control: every bf16 sum
    over 'model' takes its summands ``coarse`` mantissa bits coarser."""
    import torch
    from repro_torch.distributed import tp
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    cfg = family_config(arch)
    mod = get_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    model = mod.init(cfg, seed=0, dtype=dtype, device=dev,
                     shard=tp.Keep.of(cfg, rank, TP))
    if cast is not None:
        model.to(cast)
    place = steps.Placement(cfg, mesh)
    place.place(model)
    if batch is None:
        batch = family_batch(cfg, SCORE_B, SCORE_S, dev)
        place.run(mod.forward, {k: v[:, :128] for k, v in batch.items()})
    else:
        batch = {"tokens": torch.as_tensor(batch, device=dev)}
    torch.cuda.synchronize()
    place.par.moved.clear()
    reset_counts()
    t0 = time.perf_counter()
    with routes() as seen, _coarse_sums(coarse):
        logits = place.run(mod.forward, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tail = logits[:, -TAIL:].float().cpu()
    return dict(launches=counts(), wall_s=wall,
                shape=tuple(logits.shape),
                finite=bool(torch.isfinite(logits).all()),
                err=None if ref_logits is None else
                float((tail - ref_logits).abs().max()),
                scale=None if ref_logits is None else
                float(ref_logits.abs().max()),
                routes=None if routing is None else route_diff(seen,
                                                               routing),
                peak=torch.cuda.max_memory_allocated(dev),
                moved=dict(place.par.moved))


@contextlib.contextmanager
def _coarse_sums(bits: int):
    """Within the block, for ``bits`` > 0, ``tp.all_reduce`` rounds the
    summands of a bf16 sum to ``bits`` fewer mantissa bits (to the
    nearest, ties away from zero): a sum over 'model' at a lower
    precision than one card's, the control of (b)'s limit."""
    import torch
    from repro_torch.distributed import tp
    reduce = tp.all_reduce

    def coarse(x, ax, *, op="sum", part="tp"):
        if x.dtype == torch.bfloat16 and op == "sum":
            i = x.contiguous().view(torch.int16)
            x = ((i + (1 << bits - 1)) & -(1 << bits)).view(torch.bfloat16)
        return reduce(x, ax, op=op, part=part)

    if bits:
        tp.all_reduce = coarse
    try:
        yield
    finally:
        tp.all_reduce = reduce


def _tp_training(dev, mesh, rank, want) -> dict:
    """(e): ``build_train_step`` of gemma3_1b (full width, f32, this rank's
    shard) on phase 23's batches; losses against phase 23's
    ``make_local_train_step``."""
    import numpy as np
    import torch
    from repro_torch.configs import Shape, get_config
    from repro_torch.distributed import tp
    from repro_torch.launch import steps, train as lt
    from repro_torch.models import get_model
    cfg = get_config(TRAIN_ARCH)
    bf = lt.make_batch_fn(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B,
                          device=dev)
    batches = [{k: v.to(torch.int32) for k, v in bf(i).items()}
               for i in range(DIST_STEPS)]
    step, _ = steps.build_train_step(cfg, Shape("smoke", TRAIN_S, TRAIN_B,
                                                "train"), mesh,
                                     dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats(dev)
    model = step.place(get_model(cfg).init(
        cfg, seed=0, dtype=torch.float32, device=dev,
        shard=tp.Keep.of(cfg, rank, TP)))
    opt = step.init_opt(model)
    reset_counts()
    losses, walls = [], []
    for b in batches:
        step.par.moved.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return dict(losses=losses, want=list(want), walls=walls,
                ms=float(np.median(walls[1:])) * 1e3, launches=counts(),
                peak=torch.cuda.max_memory_allocated(dev),
                moved=dict(step.par.moved),
                params=sum(p.numel() for p in model.parameters()))


def _tp_rank(rank: int, route: str, store: str, out: str) -> None:
    """One rank of phase 24: joins the group (``route``; a ``file://``
    store, no TCP port), runs (a)-(e) on a (data 1, model TP) mesh, and
    leaves its results in ``out/rank<r>.pt``."""
    import gc
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    kw = {"device_id": dev} if route == "nccl" else {}
    dist.init_process_group(route, init_method=f"file://{store}",
                            rank=rank, world_size=TP, **kw)
    try:
        from repro_torch.launch.mesh import init_mesh
        ref = torch.load(pathlib.Path(out) / "ref.pt", weights_only=False)
        record_main_path_shapes()
        mesh = init_mesh((1, TP), ("data", "model"), "cuda")
        res = {}
        parts = (
            ("a", lambda: _tp_serving(dev, mesh, rank, ARCH, DIST_DECODE,
                                      ref["tokens " + ARCH])),
            ("b", lambda: _tp_scoring(dev, mesh, rank, ARCH,
                                      ref["logits " + ARCH],
                                      dtype=torch.bfloat16)),
            ("b32", lambda: _tp_scoring(dev, mesh, rank, ARCH,
                                        ref["logits32 " + ARCH],
                                        dtype=torch.bfloat16,
                                        cast=torch.float32)),
            ("bc", lambda: _tp_scoring(dev, mesh, rank, ARCH,
                                       ref["logits " + ARCH],
                                       dtype=torch.bfloat16,
                                       coarse=COARSE_BITS)),
            ("c", lambda: _tp_serving(dev, mesh, rank, RWKV, DIST_DECODE,
                                      ref["tokens " + RWKV])),
            ("d", lambda: _tp_scoring(dev, mesh, rank, MOE,
                                      ref["logits " + MOE],
                                      dtype=torch.float32,
                                      batch=ref["batch " + MOE],
                                      routing=ref["routes " + MOE])),
            ("d16", lambda: _tp_scoring(dev, mesh, rank, MOE, None,
                                        dtype=torch.bfloat16,
                                        routing=ref["routes16 " + MOE])),
            ("e", lambda: _tp_training(dev, mesh, rank,
                                       ref["train losses"])))
        for name, part in parts:
            res[name] = part()
            gc.collect()               # a placed model and its root: a cycle
            torch.cuda.empty_cache()
        res["shapes"] = set(USED)
        res["device"] = (torch.cuda.get_device_name(dev), dev.index)
        torch.save(res, pathlib.Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def model_axis(dev) -> dict:
    """Phase 24: the LMs on a (data 1, model TP) mesh, the ranks in
    processes of their own (``tp_route``): (a) qwen3_8b serving through
    the builders (the decode cache's positions over 'model', each step's
    ``flash_decode`` over the rank's keys with its statistics, merged
    across the ranks) against phase 10's tokens; (b) qwen3_8b bf16
    scoring, ``flash_attention`` at the rank's heads, against phase 9's
    logits, with two witnesses of its limit: the same weights in f32
    against phase 9's f32 forward, and a control whose bf16 sums over
    'model' are COARSE_BITS coarser, which the limit must reject; (c)
    rwkv6_3b serving, ``wkv6`` at the rank's heads, against phase 14's
    tokens; (d) qwen3_moe (DEPTH layers) scoring with the experts over
    'model', its routing (kept and dropped pairs) and logits against
    phase 17's f32 forward's, and in bf16 its routing against phase 17's
    bf16 scoring's; (e) gemma3_1b training, losses against phase 23's
    local step.  Returns each part's launches, summed over the ranks (the
    witnesses' apart)."""
    import gc
    import shutil
    import torch
    import torch.multiprocessing as mp
    route = tp_route()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    torch.save(REF, TP_DIR / "ref.pt")
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"      phase 24: this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved); the card "
          f"has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
    t0 = time.perf_counter()
    mp.spawn(_tp_rank, args=(route, str(TP_DIR / "store"), str(TP_DIR)),
             nprocs=TP, join=True)
    wall = time.perf_counter() - t0
    res = [torch.load(TP_DIR / f"rank{r}.pt", weights_only=False)
           for r in range(TP)]
    L, Lr, Lm = (family_config(a).n_layers for a in (ARCH, RWKV, MOE))
    gib = lambda b: f"{b / 2**30:.2f} GiB"
    mb = lambda m: ", ".join(f"{p} {k} {v / 1e6:.1f} MB"
                             for (p, k), v in sorted(m.items())) or "none"
    where = (f"{TP} ranks on {TP} cards over NCCL" if route == "nccl" else
             f"{TP} processes on one card over gloo (CUDA tensors)")
    print(f"[24/25] the LMs on a (data 1, model {TP}) mesh, {where}; "
          f"{wall:.1f} s (spawn, build and the five parts)")
    for r, x in enumerate(res):
        a = x["a"]
        expect_counts(f"24 (a) rank {r}", a["launches"],
                      flash_decode=L * (DIST_DECODE - 1))
        check(a["equal"], f"24 (a) rank {r}: tokens {a['tokens'].tolist()}"
              f" differ from phase 10's")
        check(a["cache_positions"] == (PROMPT + GEN + 8) // TP,
              f"24 (a) rank {r}: the cache holds {a['cache_positions']} "
              f"positions")
        print(f"      (a) rank {r}: {ARCH} full width f32, batch {SERVE_B},"
              f" prompt {PROMPT}, {DIST_DECODE} tokens == phase 10's; "
              f"{a['cache_positions']} of {PROMPT + GEN + 8} cache positions;"
              f" prefill {a['prefill_s']:.3f} s, wall {a['wall_s']:.3f} s "
              f"(build {a['init_s']:.2f} s), peak {gib(a['peak'])}; "
              f"launches {launched(a['launches'])}; moved: prefill "
              f"{mb(a['moved_prefill'])}; {DIST_DECODE - 1} decode steps "
              f"{mb(a['moved_decode'])}")
    bf16_f32 = float((REF["logits " + ARCH] - REF["logits32 " + ARCH])
                     .abs().max()) / float(REF["logits32 " + ARCH].abs().max())
    limit = BF16_OVER_ROUND * bf16_f32
    for r, x in enumerate(res):
        b, b32, bc = x["b"], x["b32"], x["bc"]
        for key, want in (("b", dict(fa_tensor_core=L)),
                          ("b32", dict(fa_tensor_core_tf32x3=L)),
                          ("bc", dict(fa_tensor_core=L))):
            expect_counts(f"24 ({key}) rank {r}", x[key]["launches"],
                          flash_attention=L, **want)
        rel = {k: x[k]["err"] / x[k]["scale"] for k in ("b", "b32", "bc")}
        print(f"      (b) rank {r}: {ARCH} bf16 scoring {SCORE_B}x{SCORE_S}"
              f", logits {b['shape']}: last {TAIL} positions within "
              f"{b['err']:.4g} of phase 9's (max |logit| {b['scale']:.4g}, "
              f"{rel['b']:.3e} of it, {rel['b'] / bf16_f32:.3f} x phase 9's "
              f"bf16 rounding, limit {BF16_OVER_ROUND} x); wall "
              f"{b['wall_s']:.3f} s, peak {gib(b['peak'])}; launches "
              f"{launched(b['launches'])}; moved {mb(b['moved'])}")
        print(f"          witnesses: phase 9's bf16 logits against its f32 "
              f"forward of the same weights {bf16_f32:.3e} of the largest; "
              f"this rank in f32 against that f32 forward {rel['b32']:.3e} "
              f"(limit {TP_F32_REL}; wall {b32['wall_s']:.3f} s, peak "
              f"{gib(b32['peak'])}); the control, this rank in bf16 with "
              f"each 'model' sum's summands {COARSE_BITS} mantissa bits "
              f"coarser, {rel['bc']:.3e} against phase 9's, "
              f"{rel['bc'] / bf16_f32:.3f} x its bf16 rounding (must exceed "
              f"the limit)")
        check(b["finite"] and rel["b"] <= limit,
              f"24 (b) rank {r}: logits differ from phase 9's by {b['err']}"
              f" (limit {limit:.4g} x {b['scale']})")
        check(b32["finite"] and rel["b32"] <= TP_F32_REL,
              f"24 (b) rank {r}: the f32 witness differs from phase 9's f32 "
              f"forward by {b32['err']} (limit {TP_F32_REL} x "
              f"{b32['scale']})")
        check(rel["bc"] > limit, f"24 (b) rank {r}: the control "
              f"({rel['bc']:.3e}) passes the limit {limit:.4g}")
    for r, x in enumerate(res):
        c = x["c"]
        expect_counts(f"24 (c) rank {r}", c["launches"],
                      wkv6=Lr * DIST_DECODE)
        check(c["equal"], f"24 (c) rank {r}: tokens {c['tokens'].tolist()}"
              f" differ from phase 14's")
        print(f"      (c) rank {r}: {RWKV} full width f32 serving, "
              f"{DIST_DECODE} tokens == phase 14's; prefill "
              f"{c['prefill_s']:.3f} s, wall {c['wall_s']:.3f} s, peak "
              f"{gib(c['peak'])}; launches {launched(c['launches'])}; moved: "
              f"prefill {mb(c['moved_prefill'])}; decode "
              f"{mb(c['moved_decode'])}")
    for r, x in enumerate(res):
        d, d16 = x["d"], x["d16"]
        expect_counts(f"24 (d) rank {r}", d["launches"], flash_attention=Lm,
                      fa_tensor_core_tf32x3=Lm)
        expect_counts(f"24 (d) bf16 rank {r}", d16["launches"],
                      flash_attention=Lm, fa_tensor_core=Lm)
        same = all(t["flipped"] == 0 and t["kept_diff"] == 0
                   for t in d["routes"])
        print(f"      (d) rank {r}: {MOE} ({Lm} layers) f32 forward over "
              f"phase 17's self-check prompt {d['shape'][:2]}, experts over "
              f"'model': kept pairs a layer "
              f"{[t['kept'] for t in d['routes']]}, tokens whose experts "
              f"differ {[t['flipped'] for t in d['routes']]}, kept pairs on "
              f"one side only {[t['kept_diff'] for t in d['routes']]}; "
              f"logits within {d['err']:.4g} "
              f"({d['err'] / d['scale']:.3e} of the largest); wall "
              f"{d['wall_s']:.3f} s, peak {gib(d['peak'])}; launches "
              f"{launched(d['launches'])}; moved {mb(d['moved'])}")
        print(f"          in bf16 over phase 17's {SCORE_B}x{SCORE_S} "
              f"scoring batch, against its bf16 routing: " + "; ".join(
                  f"layer {i}: {t['flipped']} tokens' experts differ, "
                  f"{t['first']} of them first here, "
                  f"{t['kept_diff']} of {t['kept']} kept pairs on one side "
                  f"only" + ("" if t["margin"] is None else
                             f"; the first ones' top-k margins: median "
                             f"{t['mid_margin']:.3e} (the lowest "
                             f"{t['mid_share']:.2%} of tokens), largest "
                             f"{t['margin']:.3e} (the lowest "
                             f"{t['margin_share']:.2%}; median of all "
                             f"{t['median_margin']:.3e})")
                  for i, t in enumerate(d16["routes"])))
        check(same and len(d["routes"]) == Lm, f"24 (d) rank {r}: the "
              f"routing differs from phase 17's: {d['routes']}")
        check(d["finite"] and d["err"] <= TP_F32_REL * d["scale"],
              f"24 (d) rank {r}: logits differ from phase 17's by "
              f"{d['err']} (limit {TP_F32_REL} x {d['scale']})")
        check(d16["finite"], f"24 (d) bf16 rank {r}: logits not finite")
    for r, x in enumerate(res):
        e = x["e"]
        expect_counts(f"24 (e) rank {r}", e["launches"])
        rel = max(abs(g - w) / abs(w) for g, w in zip(e["losses"],
                                                      e["want"]))
        check(rel <= TP_LOSS_RTOL, f"24 (e) rank {r}: losses {e['losses']}"
              f", make_local_train_step's {e['want']}")
        print(f"      (e) rank {r}: {TRAIN_ARCH} training f32 "
              f"{TRAIN_B}x{TRAIN_S}, {e['params'] / 1e9:.3f}e9 parameters a"
              f" rank: losses " + ", ".join(f"{v:.6f}" for v in e["losses"])
              + f" (max rel diff {rel:.3e} from phase 23's local step); "
              f"{e['ms']:.2f} ms a step (median of steps 1-"
              f"{DIST_STEPS - 1}; step 0 {e['walls'][0] * 1e3:.2f}), peak "
              f"{gib(e['peak'])}; moved a step {mb(e['moved'])}")
    for x in res:
        USED.update(x["shapes"])
    part = lambda key: {k: sum(x[key]["launches"][k] for x in res)
                        for k in res[0][key]["launches"]}
    return {"24 (a) serving": part("a"), "24 (b) scoring": part("b"),
            "24 (c) rwkv serving": part("c"), "24 (d) moe scoring": part("d"),
            "24 (e) training": part("e")}


# -- phase 25: bf16 training of the mixed-type LMs; remat="dots" -------------
MIXED_B, MIXED_S = 2, 128       # hymba_15b at full width: a batch and length
MIXED_STEPS = 3                 # ... that keep its 3 steps near half a minute
MIXED_REDUCED_B, MIXED_REDUCED_S = 4, 128   # reduced qwen3_moe and rwkv6
MIXED_REDUCED_STEPS = 2
# build_train_step (FSDP2 at one rank, bf16) against make_local_train_step
# in bf16: a loss within this share of the local step's (the CPU tests'
# bf16 tolerance at two ranks, tests/test_torch_fsdp_mixed.py)
MIXED_LOSS_RTOL = 2e-3
REMATS = ("none", "full", "dots", "dots", "full", "none")   # in turns
REMAT_STEPS = 3                 # steps of each turn at phase 23's cell


def _free() -> None:
    """Free what the deleted models held on the card: a placed model and
    its FSDP2 root refer to each other, so only the cycle collector frees
    them."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _mixed_cell(dev, mesh, arch: str, full: bool) -> tuple:
    """One arch's bf16 steps through ``build_train_step`` against
    ``make_local_train_step`` in bf16 on the same weights and batches:
    ``(report line, launches)``."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs import Shape, get_config
    from repro_torch.core.model import param_tree
    from repro_torch.launch import steps, train as lt
    from repro_torch.models import get_model
    cfg = get_config(arch, reduced=not full)
    B, S, n_steps = (MIXED_B, MIXED_S, MIXED_STEPS) if full else \
        (MIXED_REDUCED_B, MIXED_REDUCED_S, MIXED_REDUCED_STEPS)
    mod = get_model(cfg)
    bf = lt.make_batch_fn(cfg, seq_len=S, global_batch=B, device=dev)
    batches = [bf(i) for i in range(n_steps)]
    tx = optim.adamw(3e-4, weight_decay=0.01, max_grad_norm=1.0)
    model = mod.init(cfg, seed=0, device=dev)            # bf16, the default
    tree = param_tree(model)
    types = {k: p.dtype for k, p in tree.items()}
    f32 = sorted(k for k, t in types.items() if t == torch.float32)
    start = {k: tree[k].detach().clone() for k in f32}
    local = lt.make_local_train_step(cfg, tx)
    opt = tx.init(tree)
    want = []
    for b in batches:
        model, opt, loss = local(model, opt, b)
        want.append(float(loss))
    local_f32 = {k: param_tree(model)[k].detach().clone() for k in f32}
    del model, opt, local, loss, tree
    _free()
    step, _ = steps.build_train_step(cfg, Shape("smoke", S, B, "train"),
                                     mesh)
    torch.cuda.reset_peak_memory_stats()
    model = step.place(mod.init(cfg, seed=0, device=dev))
    opt = step.init_opt(model)
    reset_counts()
    losses, walls = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    n = counts()
    label = f"25 {arch}"
    expect_counts(label, n)
    peak = torch.cuda.max_memory_allocated()
    got = step.full_tree(model)
    check(bool(f32) and sorted(step.whole) == f32, f"{label}: f32 leaves "
          f"{f32}, the step keeps whole {sorted(step.whole)}")
    check(all(got[k].dtype == t for k, t in types.items()),
          f"{label}: a leaf changed type")
    moved = {k: float((got[k] != start[k]).float().mean()) for k in f32}
    check(all(v > 0 for v in moved.values()), f"{label}: an f32 leaf did "
          f"not move: {moved}")
    check(all(torch.isfinite(torch.tensor(losses))), f"{label}: {losses}")
    rel = max(abs(g - w) / abs(w) for g, w in zip(losses, want))
    check(rel <= MIXED_LOSS_RTOL, f"{label}: losses {losses}, "
          f"make_local_train_step's {want}")
    same_f32 = all(torch.equal(got[k], local_f32[k]) for k in f32)
    n_params = sum(p.numel() for p in model.parameters())
    ms = float(np.median(walls[1:])) * 1e3
    bound = train_bound_ms(n_params, B * S, H100_BF16_OPS_PER_S)
    line = (f"{arch} {'full width' if full else 'reduced'} "
            f"({n_params:.4g} parameters, {len(f32)} f32 leaves "
            f"kept whole: {', '.join(sorted({k.split('/', 2)[-1] for k in f32}))}"
            f"), {B}x{S}, {n_steps} steps: {ms:.2f} ms a step (median of "
            f"steps 1-{n_steps - 1}; step 0 {walls[0] * 1e3:.2f} ms), bound "
            f"{bound:.3f} ms, peak {peak / 2**30:.2f} GiB; losses "
            + ", ".join(f"{x:.6f}" for x in losses) + " vs the local "
            "step's " + ", ".join(f"{x:.6f}" for x in want)
            + f" (max rel diff {rel:.3e}, tolerance {MIXED_LOSS_RTOL:g}; "
            f"{'bit-equal' if losses == want else 'not bit-equal'}); f32 "
            f"leaves {'bit-equal' if same_f32 else 'not bit-equal'} to the "
            f"local step's, least share of elements moved "
            f"{min(moved.values()):.4f}; launches {launched(n)}")
    del model, opt, step, got
    _free()
    return line, n


def mixed_training(dev) -> dict:
    """Phase 25 on a one-rank NCCL group (a ``HashStore``): (a)
    ``build_train_step`` at its default bf16 for hymba_15b at full width
    (its SSM keeps ``A_log`` and ``D`` in f32), reduced qwen3_moe_235b (the
    router) and reduced rwkv6_3b (``w0``, ``u``), each against
    ``make_local_train_step`` in bf16: leaf types kept, every f32 leaf
    moved, losses within MIXED_LOSS_RTOL; (b) ``remat`` "none", "full" and
    "dots" in turns at phase 23's gemma3_1b full-width f32 cell: the first
    step's loss and gradients under "dots" equal "none"'s bit for bit
    (``loss_fn`` on an unplaced model), the bytes each policy's forward
    keeps for the backward ordered full < dots < none, and every turn's
    losses equal; ms a step, the first-step gradient's peak and a step's
    peak (AdamW's f32 temporaries dominate it) of each.  Returns the
    launches of each part."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import Shape, get_config
    from repro_torch.core.model import param_tree
    from repro_torch.launch import steps, train as lt
    from repro_torch.launch.mesh import init_mesh, process_group
    from repro_torch.models import get_model
    out = {}
    t_phase = time.perf_counter()
    with process_group(dev):
        mesh = init_mesh((1, 1), ("data", "model"), dev.type)
        lines = []
        for arch, full in ((HYMBA, True), (MOE, False), (RWKV, False)):
            t0 = time.perf_counter()
            line, out[f"25 {arch}"] = _mixed_cell(dev, mesh, arch, full)
            lines.append(f"{line}; {time.perf_counter() - t0:.1f} s")
        print("[25/25] bf16 training of the mixed-type LMs on a one-rank "
              "NCCL group, build_train_step at its default dtype against "
              "make_local_train_step in bf16:\n      (a) "
              + "\n      (a) ".join(lines))

        # -- (b) remat none / full / dots at phase 23's cell --------------
        gcfg = get_config(TRAIN_ARCH)
        mod = get_model(gcfg)
        bf = lt.make_batch_fn(gcfg, seq_len=TRAIN_S, global_batch=TRAIN_B,
                              device=dev)
        batches = [bf(i) for i in range(REMAT_STEPS)]
        model = mod.init(gcfg, seed=0, dtype=torch.float32, device=dev)
        pt = param_tree(model)
        first, held, grad_peak = {}, {}, {}
        for remat in ("none", "full", "dots"):
            _free()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss = mod.loss_fn(model, batches[0], remat=remat)
            held[remat] = torch.cuda.memory_allocated() - base
            grads = torch.autograd.grad(loss, list(pt.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            grad_peak[remat] = torch.cuda.max_memory_allocated() - base
            first[remat] = (loss.detach(), grads)
            del loss, grads
        diff = [k for k, a, b in zip(pt, first["none"][1], first["dots"][1])
                if not torch.equal(a, b)]
        check(torch.equal(first["none"][0], first["dots"][0]) and not diff,
              f"25 remat: the first step under 'dots' differs from 'none' "
              f"(loss {float(first['dots'][0])} vs "
              f"{float(first['none'][0])}; {len(diff)} leaves: {diff[:4]})")
        check(held["full"] < held["dots"] < held["none"],
              f"25 remat: the bytes the forward keeps for the backward "
              f"{held} are not ordered full < dots < none")
        del model, pt, first
        _free()
        cell = Shape("smoke", TRAIN_S, TRAIN_B, "train")
        runs = {}
        for remat in REMATS:
            step, _ = steps.build_train_step(gcfg, cell, mesh,
                                             dtype=torch.float32,
                                             remat=remat)
            torch.cuda.reset_peak_memory_stats()
            model = step.place(mod.init(gcfg, seed=0, dtype=torch.float32,
                                        device=dev))
            opt = step.init_opt(model)
            reset_counts()
            losses, walls = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model, opt, loss = step(model, opt, b)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(float(loss))
            n = counts()
            expect_counts(f"25 remat {remat}", n)
            out[f"25 remat {remat}"] = n
            runs.setdefault(remat, []).append(
                (losses, walls[1:], torch.cuda.max_memory_allocated()))
            del model, opt, step, loss
            _free()
        losses = {r: [x[0] for x in v] for r, v in runs.items()}
        check(all(l == losses["none"][0] for r in losses for l in losses[r]
                  if r != "full") and all(l == losses["full"][0]
                                          for l in losses["full"]),
              f"25 remat: losses differ between turns or from 'none' under "
              f"'dots': {losses}")
        peak = {r: max(x[2] for x in v) for r, v in runs.items()}
        ms = {r: sorted(w * 1e3 for x in v for w in x[1])
              for r, v in runs.items()}
        print(f"      (b) remat in turns {REMATS} at {TRAIN_ARCH} full width"
              f", f32, {TRAIN_B}x{TRAIN_S}, build_train_step on the (1, 1) "
              f"mesh, {REMAT_STEPS} steps a turn: the first step's loss "
              f"and gradients under 'dots' bit-equal to 'none''s (a plain "
              f"loss_fn); losses "
              + "; ".join(f"{r} " + ", ".join(f"{x:.6f}" for x in
                                              losses[r][0])
                          for r in ("none", "full", "dots"))
              + " (dots == none bit for bit, every turn alike); ms a step "
              "(steps 1-2 of both turns) "
              + "; ".join(f"{r} {ms[r][0]:.2f}-{ms[r][-1]:.2f}"
                          for r in ("none", "full", "dots"))
              + "; kept by the forward for the backward (GiB) "
              + "; ".join(f"{r} {held[r] / 2**30:.3f}"
                          for r in ("none", "full", "dots"))
              + " (full < dots < none); a first-step gradient's peak "
              "above the weights (GiB) " + "; ".join(
                  f"{r} {grad_peak[r] / 2**30:.3f}" for r in ("none", "full",
                                                         "dots"))
              + "; a step's peak (GiB, the update's "
              "f32 temporaries on top) " + "; ".join(
                  f"{r} {peak[r] / 2**30:.3f}" for r in ("none", "full",
                                                         "dots"))
              + f"; bound "
              f"{train_bound_ms(gcfg.param_count(), TRAIN_B * TRAIN_S):.2f}"
              f" ms")
    check(not dist.is_initialized(), "25: the process group outlived the "
          "phase")
    print(f"      phase 25 {time.perf_counter() - t_phase:.1f} s")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port "
                                 "on one CUDA card.")
    ap.add_argument("--parent-fa", type=pathlib.Path, default=None,
                    help="a tree whose src/repro_torch/kernels/csrc/"
                    "flash_attention.cu is built beside this one's, its f32 "
                    "kernel timed in turns with this one (phases 8 and 11)")
    args = ap.parse_args(argv)
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
    from repro_torch import ab_flash_attention as ab
    from repro_torch.configs import get_config
    from repro_torch.workloads import CNN_ZOO
    from repro_torch.workloads.grid import paper_grid

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # -- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[1/25] device: {kind} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | devices "
          f"{torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    sources = (fe.SOURCE, fa.SOURCE, fd.SOURCE, rk.SOURCE)
    parent_job = (ab.start_build(args.parent_fa, "parent") if args.parent_fa
                  else None)
    _build.build(*sources)
    parent = ab.finish_build(parent_job) if parent_job else None
    fe.compiled_backend_supported()
    infos = {src: _build.build_info(src) for src in sources}
    print(f"[2/25] build: " + ", ".join(
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
        info = fa.tf32_info(hd)
        print(f"      flash_attention 3xTF32 kernel at hd {hd}: "
              f"{info['threads']} threads, {info['stages']} K/V stages of "
              f"{info['keys']} keys, {info['smem_bytes']} bytes of shared "
              f"memory")
    if parent is not None:
        print(f"      parent flash_attention.cu from {args.parent_fa} built "
              f"with the same flags")

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
        print(f"[3/25] kernel == plain on {label} [{Cc}x{pop}x{P}], "
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
    print(f"[4/25] G-Sampler pop {cfg.population} x {cfg.generations} gens "
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
    print(f"[5/25] DT one shot (3x2x128, hw_dim 10, seeded random weights) "
          f"over {C} conditions: wall {dt_wall:.4f} s, valid share "
          f"{dt_valid:.4f}, mean valid speedup {dt_speed:.4f}; re-score "
          f"matches (rtol 1e-5); G-Sampler/DT wall ratio "
          f"{gs_wall / dt_wall:.1f} (informative)")

    # -- 6. the paper loop: corpus, training, answer -----------------------
    loop_launches, trained = paper_loop(
        dev, dict(workloads=workloads, hws=hws, batches=batches,
                  budgets=budgets, packed=packed, n_of=n_of),
        dict(wall=gs_wall, best=best, valid=res.valid[:, 0].mean()),
        dict(wall=dt_wall, valid=dt_valid, speedup=dt_speed))

    # -- 7. the serving stack on the card ------------------------------------
    t0 = time.perf_counter()
    serve_launches = mapper_serving(dev, trained)
    print(f"      serving phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # -- 8.-11. the dense LM: kernels, scoring, serving, self-check ---------
    L = get_config(ARCH).n_layers
    attn = attention_kernels(dev, parent)
    torch.cuda.empty_cache()
    record_main_path_shapes()
    fa_launches = scoring(dev, ARCH, 9, flash_attention=L,
                          fa_tensor_core=L)["launches"]["flash_attention"]
    served = serving(dev, ARCH, 10, gen=GEN, flash_decode=L * (GEN - 1))
    phase10_tokens = served["tokens"][:, :DIST_DECODE].copy()   # phase 23
    REF["tokens " + ARCH] = phase10_tokens                       # phase 24
    fwd = self_check(dev, ARCH, served, 11, parent=parent,
                     flash_attention=L, fa_tensor_core_tf32x3=L)
    fd_launches = served["launches"]["flash_decode"]
    del served                          # qwen3_8b is gone before rwkv6_3b

    # -- 12.-15. the RWKV6 LM: kernel, scoring, serving, self-check ---------
    L = get_config(RWKV).n_layers
    wkv = wkv_kernel(dev)
    wkv_launches = scoring(dev, RWKV, 13, wkv6=L)["launches"]["wkv6"]
    served = serving(dev, RWKV, 14, gen=GEN, wkv6=L + L * (GEN - 1))
    REF["tokens " + RWKV] = served["tokens"][:, :DIST_DECODE].copy()
    self_check(dev, RWKV, served, 15, want_prefill={"wkv6": L},
               want_step={"wkv6": L}, wkv6=L)
    wkv_served = served["launches"]["wkv6"]
    del served

    # -- 16. Table 1 and the exact optimum -----------------------------------
    table_launches = paper_table(dev, trained)
    del trained
    torch.cuda.empty_cache()

    # -- 17.-21. the rest of the LM substrate --------------------------------
    new = {}                             # phase label -> launches
    t0 = time.perf_counter()
    L = DEPTH[MOE]
    new["17 scoring"] = scoring(
        dev, MOE, 17, SCORE_B, SCORE_S, repeat=True, flash_attention=L,
        fa_tensor_core=L)["launches"]
    served = serving(dev, MOE, 17, prompt=PROMPT,
                            flash_decode=L * (NEW_GEN - 1))
    new["17 serving"] = served["launches"]
    new["17 self-check"] = self_check(
        dev, MOE, served, 17, flash_attention=L,
        fa_tensor_core_tf32x3=L)["launches"]
    del served
    print(f"      phase 17 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    L = DEPTH[GROK]
    new["18 scoring"] = scoring(
        dev, GROK, 18, SCORE_B, SCORE_S, probe=expert_loads,
        flash_attention=L, fa_tensor_core=L)["launches"]
    print(f"      phase 18 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    L = DEPTH[VLM]
    new["19 scoring"] = scoring(
        dev, VLM, 19, SCORE_B, SCORE_S, grid=32, flash_attention=L,
        fa_tensor_core=L)["launches"]
    served = serving(dev, VLM, 19, prompt=PROMPT,
                            flash_decode=L * (NEW_GEN - 1))
    new["19 serving"] = served["launches"]
    new["19 self-check"] = self_check(
        dev, VLM, served, 19, flash_attention=L,
        fa_tensor_core_tf32x3=L)["launches"]
    del served
    print(f"      phase 19 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hy = get_config(HYMBA)
    L, glob = hy.n_layers, sum(w <= 0 for w in hy.windows())
    new["20 scoring"] = scoring(
        dev, HYMBA, 20, SCORE_B, HYMBA_S, probe=scan_share,
        flash_attention=L, fa_tensor_core=L)["launches"]
    served = serving(dev, HYMBA, 20, prompt=PROMPT,
                            flash_decode=glob * (NEW_GEN - 1))
    new["20 serving"] = served["launches"]
    new["20 self-check"] = self_check(
        dev, HYMBA, served, 20, flash_attention=L,
        fa_tensor_core_tf32x3=L)["launches"]
    del served
    print(f"      phase 20 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # phase 21's CPU searches run in worker processes beside the card's
    # work; they start after phase 20, whose host-bound walls they would
    # otherwise slow
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing as mp
    from repro_torch.configs import ARCH_NAMES
    pool = ProcessPoolExecutor(max_workers=6,
                               mp_context=mp.get_context("spawn"))
    try:
        cpu_jobs = {name: pool.submit(lm_search, name, "cpu")
                    for name in ARCH_NAMES}
        new.update(whisper_and_mapping(dev, cpu_jobs))
    finally:
        pool.shutdown(cancel_futures=True)
    print(f"      phase 21 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    new.update(lm_training(dev))
    print(f"      phase 22 {time.perf_counter() - t0:.1f} s")
    new.update(distributed_half(dev, phase10_tokens))
    t0 = time.perf_counter()
    new.update(model_axis(dev))
    print(f"      phase 24 {time.perf_counter() - t0:.1f} s")
    new.update(mixed_training(dev))
    missing = sorted(USED - HELD, key=str)
    check(not missing, f"the main path launched the attention kernels at "
          f"{len(missing)} shapes that phase 8 did not hold against their "
          f"plain versions: {missing}")
    print(f"      the main path (phases 9-25) launched the attention kernels "
          f"at {len(USED)} shapes (dtype, dims, causal/window; decode kv_len "
          f"and plan), each held against its plain version in phase 8 "
          f"({len(HELD)} held)")
    new_n = lambda key: sum(n.get(key, 0) for n in new.values())
    by_phase = lambda key: {p: n[key] for p, n in new.items() if n.get(key)}
    print(f"      total {time.perf_counter() - t_all:.1f} s")

    print(smi)
    csrc = "src/repro_torch/kernels/csrc"
    print(json.dumps({"kernels": [
        {"name": "fusion_eval", "route": "cuda",
         "source": f"{csrc}/fusion_eval.cu",
         "replaces": "src/repro/kernels/fusion_eval.py:57",
         "launches": gs_launches + dt_launches + loop_launches
         + serve_launches + table_launches + new_n("fusion_eval"),
         "launches_new_phases": by_phase("fusion_eval"),
         "max_abs_err": max_err,
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
         "launches": fa_launches + new_n("fa_tensor_core"),
         "launches_new_phases": by_phase("fa_tensor_core"),
         **attn["flash_attention"]},
        {"name": "flash_attention_f32", "route": "cuda",
         "source": f"{csrc}/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:27",
         "launches": fwd["launches"]["flash_attention"]
         + new_n("fa_tensor_core_tf32x3"),
         "launches_new_phases": by_phase("fa_tensor_core_tf32x3"),
         "forward_wall_s": fwd["wall_s"],
         "parent_forward_wall_s": fwd["parent_wall_s"],
         **attn["flash_attention_f32"]},
        {"name": "flash_decode", "route": "cuda",
         "source": f"{csrc}/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:24",
         "launches": fd_launches + new_n("flash_decode"),
         "launches_new_phases": by_phase("flash_decode"),
         **attn["flash_decode"]},
        {"name": "wkv6", "route": "cuda", "source": f"{csrc}/wkv6.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:26",
         "launches": wkv_launches + wkv_served + new_n("wkv6"),
         "launches_new_phases": by_phase("wkv6"), **wkv}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
