"""Flash decoding: split-K attention of one query token over a KV cache.

Port of ``repro.kernels.flash_decode`` (the Pallas ``_fd_kernel`` and the
jnp merge after it).  The kernel is ``csrc/flash_decode.cu``: one CUDA
block per (split of ``bk`` keys, kv-head, batch) serves the kv-head's G
q-heads, streams the split's K and V through a ring of shared-memory tiles
and emits f32 partials ``(o, m, l)``; the block that finishes a kv-head
last merges its splits with the online-softmax combine, in split order, in
the same launch.  A block serves up to MAX_GROUP = 16 q-heads a kv-head
(the reference's grid runs one q-head a block and takes any G; the
port's configs need at most 16, qwen3_moe_235b's 64 over 4).  The cache
keeps the JAX layout ``[B, T, Hkv, hd]`` and is read through strides.

The split plan (:func:`split_plan`).  As in the reference
(``flash_decode.py:51-57``) the split size is clamped to the cache, ``bk =
min(bk, T)``, and a tail that is not a whole split is masked.  Only the
``ceil(kv_len / bk)`` splits that hold a visible key are computed, so a
split wholly past ``kv_len`` adds exactly zero, whatever the cache tail
holds.  An explicit ``bk`` is honoured.  ``bk=None`` is sized to the card
for CUDA tensors: the largest multiple of 64, at most the reference's 512,
that gives at least two blocks per SM (``ns * Hkv * B >= 2 * SMs``),
grown past 512 only where a long cache would otherwise need more splits
than the kernel takes (:func:`limits`); for CPU tensors, which have no
SM count, it is the reference's 512.
:func:`plan` resolves it for given tensors, so the plain twin and the
kernel cut the same splits.

``kv_len`` is a host int (the port's cache index is a Python int, so a
decode step makes no sync).  A call is one kernel launch.  Its partials and
merge counters live in one workspace per (device, stream), allocated and
zeroed once and grown when a call needs more; calls on one stream are
ordered, so they share it.

With ``stats=True`` a call also returns each (batch, q-head) row's
log-sum-exp over the keys it saw, ``lse`` [B, Hq] f32 (the splits' global
max plus the log of their merged sum, written by the launch's merge): a
sequence-parallel decode (``nn.attention``) merges its ranks' outputs over
their key shards with it (``distributed.tp.merge_partials``).  A shard
with no visible key (``kv_len`` 0) launches nothing and gives output 0
and ``lse`` -inf, which the merge weighs 0.

:func:`flash_decode_plain` is the same split-K decode and merge in plain
PyTorch: the kernel's oracle on the card and its path on the CPU.
:func:`flash_decode` takes the plain path only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import array
import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import DTYPES, HEAD_DIMS, check_qkv

__all__ = ["flash_decode", "flash_decode_plain", "split_plan", "plan",
           "check_decode", "limits", "reset_launches", "STATS", "SOURCE",
           "MAX_GROUP", "BK", "ALIGN"]

SOURCE = "flash_decode"           # csrc/flash_decode.cu
MAX_GROUP = 16                    # q-heads per kv-head a block serves
BK = 512                          # the reference's split size
BK_STEP = 64                      # the card plan's split sizes: multiples
BLOCKS_PER_SM = 2                 # the card plan's target occupancy
ALIGN = 16                        # bytes: cp.async's K/V rows
_SIZE = {torch.float32: 4, torch.bfloat16: 2}
# The kernel keeps a split's scores in shared memory: 4096 keys x 8 heads
# x 4 bytes, beside its 73 KB ring at most, stays within a block's 227 KB.
MAX_BK = 4096
# The merge stages m and l of every split of a kv-head in the ring (54 KB
# at least): 2 x 512 splits x 8 heads x 4 bytes fit.
MAX_SPLITS = 512


def limits(G: int) -> tuple[int, int]:
    """``(largest bk, most splits)`` the kernel takes at G q-heads per
    kv-head: MAX_BK and MAX_SPLITS up to 8 heads, half of each at 9-16,
    whose score rows and merge stage hold twice the heads."""
    return (MAX_BK, MAX_SPLITS) if G <= 8 else (MAX_BK // 2, MAX_SPLITS // 2)


class _Stats:
    """Launch count of the kernel (one per call, the merge included)."""

    def __init__(self):
        self.launches = 0


STATS = _Stats()


def reset_launches() -> None:
    STATS.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.flash_decode_launch.argtypes = [ctypes.c_void_p]
        lib.flash_decode_launch.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=4096)
def _plan(T: int, kv_len: int, bk: int | None, sms: int | None,
          rows: int, group: int) -> tuple[int, int]:
    if not 1 <= kv_len <= T:
        raise ValueError(f"flash_decode: kv_len {kv_len} outside [1, {T}]")
    if bk is None and sms is None:
        bk = BK
    elif bk is None:
        bk = next((c for c in range(BK, BK_STEP - 1, -BK_STEP)
                   if -(-kv_len // c) * rows >= BLOCKS_PER_SM * sms),
                  BK_STEP)
        # a cache too long for the kernel's split count at this bk: the
        # least multiple of 64 that brings it within (past limits(group)'s
        # largest split the launch raises)
        least = -(-kv_len // limits(group)[1])
        bk = max(bk, -(-least // BK_STEP) * BK_STEP)
    bk = max(1, min(bk, T))
    return bk, -(-kv_len // bk)


def split_plan(T: int, kv_len: int, bk: int | None = BK, *,
               sms: int | None = None, rows: int = 1,
               group: int = 1) -> tuple[int, int]:
    """``(bk, ns)``: the split size clamped to the cache and the number of
    splits that hold a visible key.  With ``bk=None`` and ``sms`` (the
    card's SM count), ``bk`` is the largest multiple of 64 up to 512 with
    ``ns * rows >= 2 * sms``, ``rows`` being the blocks a split spans
    (``Hkv * B``), else 64; and where that leaves more splits than the
    kernel takes at ``group`` q-heads a kv-head (:func:`limits`), the
    least multiple of 64 that does not.  With neither, 512 (the
    reference's, for the plain twin on the CPU, which takes any split
    count).  Raises unless ``1 <= kv_len <= T``."""
    return _plan(int(T), int(kv_len), bk, sms, int(rows), int(group))


def plan(q, k, kv_len: int, bk: int | None = None) -> tuple[int, int]:
    """The ``(bk, ns)`` that :func:`flash_decode` and
    :func:`flash_decode_plain` use for these tensors: an explicit ``bk``
    as given, else the card's plan for CUDA tensors and 512 for CPU
    tensors."""
    sms = _build.sm_count(q.get_device()) if bk is None and q.is_cuda \
        else None
    return _plan(k.shape[1], int(kv_len), bk, sms, k.shape[2] * q.shape[0],
                 q.shape[2] // max(k.shape[2], 1))


def _empty(q, stats: bool):
    """A shard with no visible key: output 0 and ``lse`` -inf."""
    B, _, Hq, hd = q.shape
    out = q.new_zeros((B, 1, Hq * hd))
    if not stats:
        raise ValueError("flash_decode: kv_len 0 (no visible key) needs "
                         "stats=True")
    return out, torch.full((B, Hq), float("-inf"), dtype=torch.float32,
                           device=q.device)


def flash_decode_plain(q, k, v, kv_len: int, *, bk: int | None = None,
                       stats: bool = False):
    """Split-K decode in f32 and its merge: q [B,1,Hq,hd], cache
    [B,T,Hkv,hd] -> [B,1,Hq*hd] in q's type, over the splits of
    :func:`plan`; with ``stats``, ``(out, lse [B, Hq] f32)``."""
    B, _, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if int(kv_len) == 0:
        return _empty(q, stats)
    bk, ns = plan(q, k, kv_len, bk)
    n = ns * bk                                   # keys of the live splits
    kk, vv = k[:, :n].float(), v[:, :n].float()
    if n > T:                                     # pad the tail split
        kk = F.pad(kk, (0, 0, 0, 0, 0, n - T))
        vv = F.pad(vv, (0, 0, 0, 0, 0, n - T))
    kk = kk.reshape(B, ns, bk, Hkv, hd)
    vv = vv.reshape(B, ns, bk, Hkv, hd)
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bkgh,bntkh->bkgnt", qg, kk) / math.sqrt(hd)
    ids = torch.arange(n, device=q.device).reshape(ns, bk)
    s = torch.where(ids < kv_len, s, float("-inf"))
    m = s.amax(-1)                                # [B,Hkv,G,ns]
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bkgnt,bntkh->bkgnh", p, vv)  # unnormalised partials
    mg = m.amax(-1, keepdim=True)
    w = torch.exp(m - mg)
    den = (w * l).sum(-1)
    out = (o * w[..., None]).sum(-2) / torch.clamp_min(den, 1e-30)[..., None]
    out = out.reshape(B, 1, Hq * hd).to(q.dtype)
    if not stats:
        return out
    return out, (mg[..., 0] + torch.log(den)).reshape(B, Hq)


def check_decode(q, k, v) -> tuple:
    """Raise on what the kernel does not take: ``check_qkv``'s conditions
    with one query token and v as wide as q and k (tested in one pass;
    ``check_qkv`` names the fault), at most MAX_GROUP q-heads per kv-head, and the K/V base
    addresses and the strides of their batch, step and head dims (those
    of size above 1) on 16-byte boundaries.  Returns the shapes of q and k
    and the strides of q, k and v."""
    if not (isinstance(k, torch.Tensor) and isinstance(v, torch.Tensor)):
        check_qkv("flash_decode", q, k, v, q_len=1)
    qs, ks, dt, dev = q.shape, k.shape, q.dtype, q.device
    qst, kst, vst = q.stride(), k.stride(), v.stride()
    if not (dt in DTYPES and k.dtype is dt and v.dtype is dt
            and len(qs) == 4 and len(ks) == 4 and v.shape == ks
            and qs[1] == 1 and ks[0] == qs[0] and ks[3] == qs[3]
            and (qs[3], qs[3]) in HEAD_DIMS[dt] and k.device == dev
            and v.device == dev and qst[3] == 1 and kst[3] == 1
            and vst[3] == 1) or qs[2] % ks[2]:
        check_qkv("flash_decode", q, k, v, q_len=1)
        if v.shape[3] != qs[3]:
            raise ValueError(f"flash_decode: head dims (q/k, v) "
                             f"{(qs[3], v.shape[3])}; the kernel takes v "
                             f"as wide as q and k")
    if qs[2] // ks[2] > MAX_GROUP:
        raise ValueError(f"flash_decode: {qs[2] // ks[2]} q-heads per "
                         f"kv-head, the kernel serves at most {MAX_GROUP}")
    step = ALIGN // _SIZE[dt]
    for nm, t, st in (("k", k, kst), ("v", v, vst)):
        if (t.data_ptr() % ALIGN or (st[0] % step and ks[0] > 1)
                or (st[1] % step and ks[1] > 1)
                or (st[2] % step and ks[2] > 1)):
            raise ValueError(f"flash_decode: {nm}'s base address or strides "
                             f"{tuple(st)} are not multiples of {ALIGN} "
                             f"bytes, which the kernel's cp.async loads "
                             f"need")
    return qs, ks, qst, kst, vst


_WORK: dict[tuple[int, int], tuple[torch.Tensor, int, int]] = {}


def _workspace(index: int, stream: int, ncnt: int, nfloat: int):
    """A (device, stream)'s workspace grown to ``ncnt`` int32 merge
    counters (zero between launches) and ``nfloat`` f32 partials after
    them, allocated and zeroed anew: ``(buffer, counters, partials)``."""
    old = _WORK.get((index, stream), (None, 0, 0))
    ncnt = max(old[1], -(-ncnt // 4) * 4)
    nfloat = max(old[2], nfloat)
    ws = (torch.zeros(ncnt + nfloat, dtype=torch.int32,
                      device=torch.device("cuda", index)), ncnt, nfloat)
    _WORK[(index, stream)] = ws
    return ws


def _launch(q, k, v, kv_len: int, bk: int | None, stats: bool):
    (B, _, Hq, hd), (_, T, Hkv, _), qst, kst, vst = check_decode(q, k, v)
    index = q.get_device()
    bk, ns = plan(q, k, kv_len, bk)
    max_bk, max_ns = limits(Hq // Hkv)
    if bk > max_bk or ns > max_ns:
        raise ValueError(f"flash_decode: bk {bk} above {max_bk} or {ns} "
                         f"splits above {max_ns} at {Hq // Hkv} q-heads a "
                         f"kv-head, the kernel's shared memory for a "
                         f"split's scores or the merge")
    out = q.new_empty((B, 1, Hq * hd))
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device) \
        if stats else None
    if B == 0:
        return (out, lse) if stats else out
    stream = torch._C._cuda_getCurrentRawStream(index)
    ws = _WORK.get((index, stream))
    if ws is None or ws[1] < B * Hkv or ws[2] < B * Hq * ns * (hd + 2):
        ws = _workspace(index, stream, B * Hkv, B * Hq * ns * (hd + 2))
    work, ncnt = ws[0], ws[1]
    args = array.array("q", (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        work.data_ptr(), ncnt, DTYPES[q.dtype], B, Hq, Hkv, hd, kv_len, bk,
        ns, qst[0], qst[2], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2],
        index, stream, lse.data_ptr() if stats else 0))
    rc = _lib().flash_decode_launch(args.buffer_info()[0])
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    STATS.launches += 1
    return (out, lse) if stats else out


def flash_decode(q, k, v, kv_len: int, *, bk: int | None = None,
                 stats: bool = False):
    """q [B,1,Hq,hd] over the first ``kv_len`` keys of the cache k/v
    [B,T,Hkv,hd] -> [B,1,Hq*hd]: the kernel for CUDA tensors, the plain
    twin for CPU tensors, both over the splits of :func:`plan`.  With
    ``stats``, ``(out, lse [B, Hq] f32)``, and ``kv_len`` may be 0 (no
    launch).  Refuses inputs that require grad under grad mode
    (:func:`_build.refuse_grad`)."""
    _build.refuse_grad("flash_decode", q, k, v)
    kv_len = int(kv_len)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    if kv_len == 0:
        return _empty(q, stats)
    if q.is_cuda:
        return _launch(q, k, v, kv_len, bk, stats)
    return flash_decode_plain(q, k, v, kv_len, bk=bk, stats=stats)
