"""Deterministic, resumable, sharded synthetic-LM data pipeline (a numpy
copy of ``repro.data.pipeline``).

Batches are a pure function of (seed, step, shard): numpy's
``default_rng((seed, step))``, the reference's stream, so a resumed job at
step N reproduces the exact global batch without persisted iterator state,
and the port's batches are byte-equal to the reference's.  The token
stream is Zipf-ish with short-range structure, so losses actually fall.
Batches stay numpy arrays; the trainer moves them to its device.

``Prefetcher`` overlaps host batch synthesis with device compute with a
bounded queue.  Its thread only calls the batch function, so with a numpy
batch function it never touches the device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticLM", "Prefetcher", "make_batch_iterator"]


@dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_dim: int | None = None    # for embed-input (stub frontend) archs
    dec_len: int | None = None      # for enc-dec archs

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The full global batch for ``step`` (pure function of inputs)."""
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # zipf-ish marginals + markov-ish structure: next token depends on
        # previous via a fixed random permutation half the time
        base = rng.zipf(1.3, size=(B, S)).astype(np.int64) % V
        perm = np.random.default_rng(self.seed).permutation(V)
        shifted = perm[np.roll(base, 1, axis=1) % V]
        use_prev = rng.random((B, S)) < 0.5
        toks = np.where(use_prev, shifted, base).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        out = {"tokens": toks, "labels": labels}
        if self.embed_dim is not None:
            out["embeds"] = rng.standard_normal(
                (B, S, self.embed_dim)).astype(np.float32) * 0.02
        if self.dec_len is not None:
            dt = toks[:, : self.dec_len]
            out["tokens"] = dt
            out["labels"] = np.roll(dt, -1, axis=1)
        return out

    def shard_at(self, step: int, shard: int, n_shards: int) -> dict:
        """This host-shard's slice of the global batch (per-host loading)."""
        full = self.batch_at(step)
        B = self.global_batch
        lo, hi = B * shard // n_shards, B * (shard + 1) // n_shards
        return {k: v[lo:hi] for k, v in full.items()}


class Prefetcher:
    """Bounded-queue background prefetch of host batches."""

    def __init__(self, fn, start_step: int = 0, depth: int = 2):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def make_batch_iterator(source: SyntheticLM, start_step: int = 0,
                        prefetch: int = 2):
    """Iterator of (step, global_batch) with background prefetch."""
    pf = Prefetcher(source.batch_at, start_step=start_step, depth=prefetch)
    try:
        while True:
            yield pf.next()
    finally:
        pf.close()
