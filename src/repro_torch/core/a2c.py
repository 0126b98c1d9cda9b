"""A2C baseline (paper §5.1, Table 1 "A2C").

Port of ``repro.core.a2c``: a small actor-critic agent stepping the host
fusion environment.  The paper reports that A2C barely finds a valid
solution after ~5 hours and falls below the baseline mapping: the
environment's state changes abruptly from step to step (layer shapes have
no smooth relation), which starves temporal-difference methods.  The
method is the reference's: a discrete action head over {SYNC} u [1..B],
advantage actor-critic with an entropy bonus, AdamW with clipping.

The agent is a host loop by nature: each step samples one action on the
model's device and reads it back (one sync a step), and ``FusionEnv.step``
scores the new prefix (one ``fusion_eval`` launch on the card).  The
initial weights and the actions are drawn from one ``torch.Generator`` on
the env's device seeded with ``seed`` (Gumbel-max sampling, as JAX's
``categorical``), so a run is deterministic per seed and device; torch's
streams are not JAX's, so it is compared with the reference on quality.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import optim
from . import cost_model as cm
from .baselines import SearchResult
from .env import STATE_DIM

__all__ = ["a2c_search"]


def _init_params(gen: torch.Generator, n_actions: int,
                 hidden: int = 64) -> dict:
    """The reference's layout and scales, drawn from ``gen`` on its
    device in the reference's key order (w1, wp, wv, w2)."""
    dev = gen.device

    def sc(i, o):
        return torch.randn((i, o), generator=gen, device=dev) / math.sqrt(i)

    w1, wp, wv, w2 = (sc(STATE_DIM, hidden), sc(hidden, n_actions),
                      sc(hidden, 1), sc(hidden, hidden))
    z = lambda n: torch.zeros(n, device=dev)
    params = {"w1": w1, "b1": z(hidden), "wp": wp, "bp": z(n_actions),
              "wv": wv, "bv": z(1), "w2": w2, "b2": z(hidden)}
    return {k: v.requires_grad_() for k, v in params.items()}


def _forward(params: dict, s):
    h = torch.tanh(s @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    logits = h @ params["wp"] + params["bp"]
    value = (h @ params["wv"] + params["bv"])[..., 0]
    return logits, value


@torch.no_grad()
def _sample_action(params: dict, s, gen: torch.Generator):
    """An action drawn from the policy's logits by the Gumbel-max trick."""
    logits, _ = _forward(params, s)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)))


def _loss(params: dict, states, actions, returns, beta: float):
    logits, values = _forward(params, states)
    logp = torch.log_softmax(logits, dim=-1)
    lp_a = torch.gather(logp, 1, actions[:, None])[:, 0]
    adv = returns - values.detach()
    pg = -(lp_a * adv).mean()
    vloss = 0.5 * torch.mean((values - returns) ** 2)
    ent = -torch.mean(torch.sum(torch.exp(logp) * logp, dim=1))
    return pg + 0.5 * vloss - beta * ent


def a2c_search(env, budget: int = 2000, seed: int = 0,
               gamma: float = 0.99, lr: float = 3e-4,
               entropy_beta: float = 1e-2) -> SearchResult:
    """Train A2C for ``budget`` episodes on the env's device; return the
    best strategy seen."""
    t0 = time.perf_counter()
    dev = env.device
    n_actions = env.batch + 1          # 0 => SYNC, k => micro-batch k
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = _init_params(gen, n_actions)
    tx = optim.adamw(lr, max_grad_norm=1.0)
    opt_state = tx.init(params)

    def loss_fn(b):
        return _loss(params, b["states"], b["actions"], b["returns"],
                     entropy_beta)

    best_strat, best_obj = None, -np.inf
    for _ in range(budget):
        s = env.reset()
        states, actions, rewards = [], [], []
        done = False
        while not done:
            a = int(_sample_action(params, torch.as_tensor(s, device=dev),
                                   gen))
            states.append(s)
            actions.append(a)
            s, r, done = env.step(cm.SYNC if a == 0 else a)
            rewards.append(r)
        # returns (terminal-heavy reward, discounted backwards)
        R, returns = 0.0, []
        for r in reversed(rewards):
            R = r + gamma * R
            returns.append(R)
        returns = returns[::-1]
        final = rewards[-1]
        if final > best_obj:
            best_obj = final
            best_strat = env.actions.copy()
        batch = {"states": torch.as_tensor(np.stack(states), device=dev),
                 "actions": torch.as_tensor(np.array(actions, np.int64),
                                            device=dev),
                 "returns": torch.as_tensor(np.array(returns, np.float32),
                                            device=dev)}
        _, grads = optim.value_and_grad(loss_fn, params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        optim.apply_updates(params, updates)

    out = env.evaluate_strategy(best_strat)
    lat, peak = float(out.latency), float(out.peak_mem)
    return SearchResult("A2C", best_strat, env.baseline_latency / lat, lat,
                        peak, bool(out.valid), budget,
                        time.perf_counter() - t0)
