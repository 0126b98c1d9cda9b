"""Data-parallel engine replicas (port of ``repro.serving.replicas``).

One ``MapperEngine`` drives N devices: the model is copied once to each
(``replicate_params``), and every formed tick, whose lanes are
independent rows of one batched episode, is cut along its rows
(``shard_tick``) and each share runs on its own device, under
``torch.cuda.device(d)`` so that every launch (``fusion_eval`` included,
which refuses a tensor off the current device) lands where its tensors
live.  Every replica's share is dispatched before any result is read, so
several cards overlap.

The unit of the cut is the episode's lane block: on the card an episode
runs on blocks of exactly ``infer.LANE_BLOCK`` lanes (which is what makes
a row's answer the same in any batch), so a replica takes whole blocks and
a row's answer does not change with the replica count.  The CPU runs one
episode over all rows, and a replica takes ``width / n`` contiguous rows,
as the reference's leading-axis sharding deals them.  Per-row results are
therefore bit-identical to the single-device engine.
``ReplicaGroup.stats()`` merges per-replica accounting (rows routed to
each replica, sharded calls) into ``MapperEngine.stats()``.
"""
from __future__ import annotations

import contextlib
import copy

import torch

from ..core.infer import lane_block

__all__ = ["ReplicaGroup"]


class ReplicaGroup:
    """N data-parallel serving replicas.

    ``n`` defaults to every visible CUDA device (``devices`` overrides the
    list, e.g. ``("cpu", "cpu")`` for the CPU tests).  The group owns
    placement (model copies, tick cuts) and per-replica accounting; the
    engine owns batching, caching and signature counting."""

    def __init__(self, n: int | None = None, devices=None):
        if devices is None:
            avail = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if n is None:
                n = avail
            if n < 1 or n > avail:
                raise ValueError(f"need 1 <= replicas <= {avail} visible "
                                 f"devices, got {n}")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [torch.device(d) for d in devices]
            if n is None:
                n = len(devices)
            if n < 1 or n != len(devices):
                raise ValueError(f"need 1 <= replicas <= {len(devices)} "
                                 f"visible devices, got {n}")
        if n & (n - 1):
            raise ValueError(f"replica count must be a power of two to "
                             f"align with pow2 tick buckets, got {n}")
        self.n = int(n)
        self.devices = [torch.device("cuda", torch.cuda.current_device())
                        if d.type == "cuda" and d.index is None else d
                        for d in devices]
        self.rows_per_replica = [0] * self.n
        self.sharded_calls = 0

    def replicate_params(self, model) -> list:
        """One copy of the model per replica (at engine init and on every
        hot swap); a replica on the model's own device shares it."""
        have = next(model.parameters()).device
        return [model if d == have else copy.deepcopy(model).to(d)
                for d in self.devices]

    def pad_width(self, width: int) -> int:
        """Padded tick width: at least one lane per replica (one layout
        per shape, as the reference keeps its warmed set closed)."""
        return max(int(width), self.n)

    def split(self, width: int) -> list[tuple[int, int]]:
        """``(start, stop)`` rows of each replica for a ``width``-lane
        tick: whole lane blocks on the card (the last possibly short),
        ``width / n`` rows on the CPU; a replica may get none."""
        unit = lane_block(self.devices[0]) or -(-width // self.n)
        blocks = -(-width // unit)
        per = -(-blocks // self.n)
        return [(min(i * per * unit, width), min((i + 1) * per * unit, width))
                for i in range(self.n)]

    def shard_tick(self, tree: dict, width: int) -> list:
        """Each replica's rows of a formed tick's per-row tensors (``None``
        leaves pass), on its device; ``None`` for a replica with none."""
        self.sharded_calls += 1
        out = []
        for (lo, hi), d in zip(self.split(width), self.devices):
            if lo == hi:
                out.append(None)
                continue
            out.append({k: None if v is None else v[lo:hi].to(d)
                        for k, v in tree.items()})
        return out

    def on(self, i: int):
        """Context making replica ``i``'s device the current one."""
        d = self.devices[i]
        return torch.cuda.device(d) if d.type == "cuda" \
            else contextlib.nullcontext()

    def account_rows(self, width: int) -> None:
        """Attribute a ``width``-lane call's rows to their replicas."""
        for i, (lo, hi) in enumerate(self.split(width)):
            self.rows_per_replica[i] += hi - lo

    def stats(self) -> dict:
        return {
            "n_replicas": self.n,
            "devices": [str(d) for d in self.devices],
            "platform": self.devices[0].type,
            "sharded_calls": self.sharded_calls,
            "rows_per_replica": list(self.rows_per_replica),
        }
