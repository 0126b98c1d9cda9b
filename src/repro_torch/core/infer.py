"""One-shot inference: the paper's headline capability (§4.5.2).

Port of ``repro.core.infer``.  Two implementations:

- ``dnnfuser_infer``, the host reference (``_rollout``): a Python loop
  that re-runs the model's full-sequence forward at every step, decodes
  the action on the host and probes the budget guard with full
  ``FusionEnv.evaluate_strategy`` calls (one ``fusion_eval`` launch each on
  the card) -- the readable oracle;
- ``dnnfuser_infer_batch`` / ``dnnfuser_infer_fused``, the fused, batched
  episode described below.

In the fused episode every row of a stack of (workload, batch, budget,
accelerator) conditions is rolled out in lockstep: at step t each row
observes (r_t, s_t) from the O(1) prefix carry, the model decodes one step
over its KV cache, the budget guard halves or syncs the action until the
staged prefix fits, and the env commits it. Positions past a row's true
``n`` are masked to SYNC.

The reference's guard is a ``lax.while_loop``; here it is a fixed-trip
masked loop of floor(log2 max B) + 1 rounds (halving from at most B down
to 1, then one step to SYNC), which is equivalent because a row whose
probe fits never changes again. So the episode makes no host sync: no
``.item()`` and no Python branch on a device tensor.

On the card a batch of rows runs as episodes of exactly ``LANE_BLOCK``
lanes (the last block padded), so that every operation, the DT's GEMMs
included, has one shape whatever the batch's size: a row's answer is then
bit-identical in a batch of any size and in any company.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from . import cost_model as cm
from .accel import accel_features, stack_hw
from .backend import backend_for
from .env import (STATE_DIM, FusionEnv, decode_action, encode_action,
                  env_final, env_make, env_observe, env_reset, env_step)

__all__ = ["InferResult", "dnnfuser_infer", "dnnfuser_infer_batch",
           "dnnfuser_infer_fused", "guard_rounds", "lane_block",
           "LANE_BLOCK"]

# Lanes of one batched episode on the card.  cuBLAS picks a GEMM's
# algorithm (and with it the order of its sums) by the problem's shape, so
# the DT's logits for a row could differ in the last bit between a batch of
# 16 rows and one of 120, and a trained mapper's action, which often lands
# near a rounding tie, could differ with them.  Run on blocks of this many
# lanes, a row's answer is the same in any batch.
LANE_BLOCK = 128


@dataclass
class InferResult:
    strategy: np.ndarray
    speedup: float
    latency: float
    peak_mem: float
    valid: bool
    wall_s: float
    n_model_calls: int


def _rollout(backend, model, env: FusionEnv, *, repair: bool) -> InferResult:
    cfg = model.cfg
    T = cfg.max_steps
    dev = env.device
    rtg = np.zeros((1, T), np.float32)
    states = np.zeros((1, T, STATE_DIM), np.float32)
    actions = np.zeros((1, T), np.float32)
    hwf = (torch.as_tensor(env.hw_features[None], device=dev)
           if cfg.hw_dim else None)
    t0 = time.perf_counter()
    s = env.reset()
    calls = 0
    for t in range(env.n + 1):
        states[0, t] = s
        rtg[0, t] = env.reward_to_go
        with torch.inference_mode():
            pred = backend.forward(model, torch.as_tensor(rtg, device=dev),
                                   torch.as_tensor(states, device=dev),
                                   torch.as_tensor(actions, device=dev), hwf)
        calls += 1
        a = int(decode_action(float(pred[0, t]), env.batch))
        if t == 0 and a < 1:
            a = 1                      # the input micro-batch cannot sync
        if repair and a >= 1 and t > 0:
            # inference-time budget guard: halve, then sync, until the
            # staged prefix (the rest SYNC) fits the budget
            while a >= 1:
                probe = env.actions.copy()
                probe[t] = a
                probe = np.where(np.arange(env.nmax) <= t, probe, cm.SYNC)
                out = env.evaluate_strategy(probe)
                if float(out.peak_mem) <= env.budget_bytes:
                    break
                a = a // 2 if a > 1 else cm.SYNC
        actions[0, t] = encode_action(np.float32(a), env.batch)
        s, _, _ = env.step(a)
    wall = time.perf_counter() - t0
    strat = env.actions.copy()
    out = env.evaluate_strategy(strat)
    return InferResult(strat, env.baseline_latency / float(out.latency),
                       float(out.latency), float(out.peak_mem),
                       bool(out.valid), wall, calls)


def dnnfuser_infer(model, env: FusionEnv, *,
                   repair: bool = True) -> InferResult:
    """Conditional autoregressive inference of one condition, the host
    reference path, on the env's device (the model must be there)."""
    if model.head.w.device != env.device:
        raise ValueError(f"model is on {model.head.w.device}, the env on "
                         f"{env.device}")
    return _rollout(backend_for(model.cfg), model, env, repair=repair)


def guard_rounds(max_batch: int) -> int:
    """Rounds after which the halve-or-sync guard has settled every row:
    floor(log2 B) halvings from at most B down to 1, then one to SYNC."""
    return int(math.floor(math.log2(max(int(max_batch), 1)))) + 1


def _guard(consts, carry, a, hw, rounds: int):
    """Shrink / sync ``a`` [R] until the staged prefix plus an all-SYNC
    suffix fits the budget (the reference's inference-time guard)."""
    pc = consts.pc
    for _ in range(rounds):
        over = (a >= 1) & (cm.prefix_probe_peak(pc, carry, a, hw) > pc.budget)
        a = torch.where(over, torch.where(a > 1, a // 2, cm.SYNC), a)
    return a


def _fused_episode(model, wl, batch, budget_bytes, hw, hw_feats,
                   repair: bool, rounds: int, backend) -> dict:
    """One batched episode over rows ``wl`` [R, P]; returns stacked [R]
    (strategy [R, P]) tensors on the rows' device."""
    consts = env_make(wl, batch, budget_bytes, hw)
    B, n = consts.pc.B, consts.pc.n
    R, P = wl["A"].shape

    carry = env_reset(consts)
    r0, s0 = env_observe(consts, carry, hw)
    pred0, mstate = backend.prefill(model, backend.state_init(model, R),
                                    r0, s0, hw_feats)
    a0 = torch.clamp_min(decode_action(pred0, B), 1)
    carry = env_step(consts, carry, a0, hw)
    actions = torch.full((R, P), cm.SYNC, dtype=torch.int32, device=B.device)
    actions[:, 0] = a0
    a_prev = a0
    for t in range(1, P):
        active = t <= n
        r_t, s_t = env_observe(consts, carry, hw)
        pred, mstate = backend.step(model, mstate, r_t, s_t,
                                    encode_action(a_prev, B), hw_feats)
        a = decode_action(pred, B)
        if repair:
            a = _guard(consts, carry, a, hw, rounds)
        a = torch.where(active, a, cm.SYNC)
        carry = cm._select(active, env_step(consts, carry, a, hw), carry)
        actions[:, t] = a
        a_prev = torch.where(active, a, a_prev)
    out = env_final(consts, carry, hw)
    return dict(strategy=actions, latency=out.latency,
                peak_mem=out.peak_mem, traffic=out.traffic, valid=out.valid,
                n_groups=out.n_groups,
                speedup=consts.base_lat / torch.clamp_min(out.latency, 1e-12),
                baseline_latency=consts.base_lat)


def dnnfuser_infer_batch(model, env_or_wl, batches, budgets_bytes, hw=None,
                         *, repair: bool = True, device=None) -> dict:
    """Serve a stack of (workload, batch, budget, accelerator) conditions in
    one batched episode.

    ``env_or_wl`` is a FusionEnv or packed workload shared by every row, a
    sequence of them (one network per row, same ``nmax``), or a stacked
    dict from ``cost_model.stack_workloads``.  ``batches`` and
    ``budgets_bytes`` are 1-D host array-likes of equal length C; ``hw`` is
    anything ``accel.stack_hw`` accepts (optional with FusionEnvs).
    Returns a dict of tensors on ``device``: strategy [C, P] int32 and
    latency / peak_mem / traffic / valid / n_groups / speedup [C]."""
    dev = resolve_device(device)
    if isinstance(env_or_wl, FusionEnv):
        rows, hw = [env_or_wl.wl], (env_or_wl.hw if hw is None else hw)
    elif isinstance(env_or_wl, (list, tuple)):
        rows = [e.wl if isinstance(e, FusionEnv) else e for e in env_or_wl]
        if hw is None:
            if not all(isinstance(e, FusionEnv) for e in env_or_wl):
                raise ValueError("hw is required with packed workloads")
            hw = [e.hw for e in env_or_wl]
    else:
        rows = None
        if hw is None:
            raise ValueError("hw is required with a packed workload")
    batches = np.asarray(batches, np.float32).reshape(-1)
    budgets = np.asarray(budgets_bytes, np.float32).reshape(-1)
    C = batches.shape[0]
    if budgets.shape[0] != C:
        raise ValueError(f"{C} batches but {budgets.shape[0]} budgets")
    if rows is None:
        wl = env_or_wl
    elif len(rows) == 1:
        wl = {k: v.expand(C, *v.shape) for k, v in rows[0].items()}
    else:
        wl = cm.stack_workloads(rows)
    if wl["n"].dim() != 1 or wl["n"].shape[0] != C:
        raise ValueError(f"workloads have {tuple(wl['n'].shape)} rows, "
                         f"expected {C}")
    if wl["A"].device != dev:
        raise ValueError(f"workloads are on {wl['A'].device}, the episode "
                         f"runs on {dev}")
    if model.head.w.device != dev:
        raise ValueError(f"model is on {model.head.w.device}, the episode "
                         f"runs on {dev}")
    hwv = stack_hw(hw, C, dev)
    hwf = accel_features(hwv) if model.cfg.hw_dim else None
    return _fused_batch(model, wl, torch.as_tensor(batches, device=dev),
                        torch.as_tensor(budgets, device=dev), hwv, hwf,
                        repair=repair, max_batch=batches.max(initial=1.0))


def lane_block(device) -> int | None:
    """Lanes an episode runs on at once: :data:`LANE_BLOCK` on the card,
    all of them (None) on the CPU."""
    return LANE_BLOCK if torch.device(device).type == "cuda" else None


def _fused_batch(model, wl: dict, batches, budgets, hw, hw_feats, *,
                 repair: bool, max_batch) -> dict:
    """The batched episode over pre-stacked rows, all on one device and
    checked by the caller: ``wl`` [R, P] tensors, ``batches``/``budgets``
    [R] f32, hw rows [R, 10], ``hw_feats`` [R, 10] (or None for an
    unconditioned model); ``max_batch`` (a host number, at least every
    row's batch) sizes the guard.  The entry the serving engine calls once
    per chunk.  Returns stacked [R] tensors (strategy [R, P]) there.

    The rows run in episodes of :func:`lane_block` lanes (the last block
    padded with copies of its last row), so every operation of a block has
    one shape whatever R is; on the CPU, one episode over the R rows."""
    rounds, backend = guard_rounds(max_batch), backend_for(model.cfg)
    lb = lane_block(batches.device)
    R = batches.shape[0]
    with torch.inference_mode():
        if lb is None:
            return _fused_episode(model, wl, batches, budgets, hw, hw_feats,
                                  repair, rounds, backend)
        outs = []
        for start in range(0, R, lb):
            idx = torch.arange(start, start + lb, device=batches.device)
            idx = idx.clamp_max(R - 1)
            take = lambda x: None if x is None else x.index_select(0, idx)
            outs.append(_fused_episode(
                model, {k: take(v) for k, v in wl.items()}, take(batches),
                take(budgets), take(hw), take(hw_feats), repair, rounds,
                backend))
        return {k: torch.cat([o[k] for o in outs])[:R] for k in outs[0]}


def dnnfuser_infer_fused(model, env: FusionEnv, *,
                         repair: bool = True) -> InferResult:
    """One condition through the batched episode, results on the host."""
    t0 = time.perf_counter()
    out = dnnfuser_infer_batch(model, env, [env.batch], [env.budget_bytes],
                               repair=repair, device=env.device)
    strat = out["strategy"][0].cpu().numpy()     # device sync = episode end
    wall = time.perf_counter() - t0
    return InferResult(strat, float(out["speedup"][0]),
                       float(out["latency"][0]), float(out["peak_mem"][0]),
                       bool(out["valid"][0]), wall, env.n + 1)
