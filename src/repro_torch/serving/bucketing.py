"""Shape bucketing: the closed set of serving signatures.

Port of ``repro.serving.bucketing`` (pure Python, copied).  The reference
buckets shapes because a jitted program is specialized to them; eager
PyTorch compiles nothing, but the port keeps the same closed set, because
it bounds the distinct shapes the card runs and is where a captured graph
per signature would live:

 - request batches round UP to powers of two (:func:`batch_bucket`); the
   spare lanes are padded with copies of a real row.  Lanes of the batched
   episode are independent, so padding cannot perturb the real rows;
 - workload length (``n + 1`` positions incl. the input pseudo-tensor)
   rounds UP to an ``nmax`` bucket (:func:`nmax_bucket`); positions past a
   row's true ``n`` are masked to SYNC inside the episode, so a short
   network padded into a long bucket rolls out alike;
 - budgets (and batch sizes) are VALUES, not shapes, but the strategy
   cache can quantize budgets (:func:`budget_bucket`) so near-identical
   conditions share one solved strategy.

The closed set is ``{nmax buckets} x {pow2 request batches}``; the engine
warms it once and counts the signatures it materializes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Iterable, Sequence

__all__ = ["batch_bucket", "nmax_bucket", "budget_bucket",
           "default_nmax_buckets", "pow2_buckets", "pow2_chunks", "coalesce"]

MB = float(2 ** 20)


def batch_bucket(c: int) -> int:
    """Smallest power of two >= ``c`` (the padded request-batch size)."""
    if c < 1:
        raise ValueError(f"need at least one request, got {c}")
    return 1 << (c - 1).bit_length()


def pow2_buckets(max_bucket: int) -> tuple[int, ...]:
    """All request-batch buckets up to ``batch_bucket(max_bucket)``."""
    top = batch_bucket(max_bucket)
    return tuple(1 << i for i in range(top.bit_length()))


def pow2_chunks(c: int, cap: int) -> tuple[int, ...]:
    """Split a group of ``c`` requests into device-call chunk sizes, each
    no wider than ``cap`` (the widest warmed pow2 bucket).

    The oversized-tick escape hatch: a tick wider than the
    warmed set must NOT pad up to an unwarmed pow2 program — it is cut
    into full ``cap``-wide chunks plus one remainder chunk that pads to
    its own (warmed, <= cap) pow2 bucket.  E.g. ``pow2_chunks(23, 8) ==
    (8, 8, 7)`` — the trailing 7 pads to the warmed 8-lane program."""
    if c < 1:
        raise ValueError(f"need at least one request, got {c}")
    cap = batch_bucket(cap)
    full, rem = divmod(c, cap)
    return (cap,) * full + ((rem,) if rem else ())


def nmax_bucket(n_pos: int, buckets: Sequence[int]) -> int:
    """Smallest configured ``nmax`` bucket holding ``n_pos`` positions.

    ``n_pos`` is ``workload.n + 1`` (layers + the input pseudo-tensor).
    Raises when the network is longer than every bucket — the caller must
    configure a bucket (<= the model's ``max_steps``) that fits."""
    for b in sorted(buckets):
        if n_pos <= b:
            return b
    raise ValueError(f"workload needs {n_pos} positions but the largest "
                     f"nmax bucket is {max(buckets)}")


def default_nmax_buckets(max_steps: int) -> tuple[int, ...]:
    """Powers of two from 8 up to (and always including) ``max_steps``.

    ``max_steps`` is the model's trajectory capacity — the hard ceiling on
    any bucket, since timestep embeddings only exist below it."""
    out = [b for b in (8, 16, 32, 64, 128) if b < max_steps]
    return tuple(out + [max_steps])


def budget_bucket(budget_bytes: float, quantum_bytes: float = MB) -> int:
    """Quantized budget id for strategy-cache keys (NOT a shape bucket).

    Requests whose budgets fall in the same quantum share a cached
    strategy; the cache re-derives validity against each request's exact
    budget from the stored peak memory, so a reused strategy can never be
    reported valid for a budget it overflows."""
    if budget_bytes <= 0:
        raise ValueError(f"budget must be positive, got {budget_bytes}")
    return int(budget_bytes // float(quantum_bytes))


def coalesce(items: Iterable, key: Callable) -> "OrderedDict":
    """Group ``items`` by ``key`` preserving first-seen group order.

    The engine's request planner: one group per ``nmax`` bucket -> one
    fused device call per group."""
    groups: OrderedDict = OrderedDict()
    for it in items:
        groups.setdefault(key(it), []).append(it)
    return groups
