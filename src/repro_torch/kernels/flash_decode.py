"""Flash decoding: split-K attention of one query token over a KV cache.

Port of ``repro.kernels.flash_decode`` (the Pallas ``_fd_kernel`` and the
jnp merge after it).  The kernel is ``csrc/flash_decode.cu``: phase 1 runs
one CUDA block per (split of ``bk`` keys, kv-head, batch) serving the
kv-head's G q-heads and emits f32 partials ``(o, m, l)``; phase 2 merges
the splits with the online-softmax combine.  The cache keeps the JAX
layout ``[B, T, Hkv, hd]`` and is read through strides.

``kv_len`` is a host int (the port's cache index is a Python int, so a
decode step makes no sync).  As in the reference (``flash_decode.py:51-
57``) the split size is clamped to the cache, ``bk = min(bk, T)``, and a
tail that is not a whole split is masked.  Only the ``ceil(kv_len / bk)``
splits that hold a visible key are computed, so a split wholly past
``kv_len`` adds exactly zero, whatever the cache tail holds.

:func:`flash_decode_plain` is the same split-K decode and merge in plain
PyTorch: the kernel's oracle on the card and its path on the CPU.
:func:`flash_decode` takes the plain path only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import DTYPES, check_qkv

__all__ = ["flash_decode", "flash_decode_plain", "split_plan",
           "reset_launches", "STATS", "SOURCE", "MAX_GROUP", "BK"]

SOURCE = "flash_decode"           # csrc/flash_decode.cu
MAX_GROUP = 8                     # q-heads per kv-head a block serves
BK = 512                          # default split size, as the reference's


class _Stats:
    """Launch count of the kernel (one per call: both phases)."""

    def __init__(self):
        self.launches = 0


STATS = _Stats()


def reset_launches() -> None:
    STATS.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_decode_launch.argtypes = ([vp] * 7 + [ci] * 8 + [ll] * 8
                                            + [vp])
        lib.flash_decode_launch.restype = ci
        lib._argtypes_set = True
    return lib


def split_plan(T: int, kv_len: int, bk: int = BK) -> tuple[int, int]:
    """``(bk, ns)``: the split size clamped to the cache and the number of
    splits that hold a visible key.  Raises unless ``1 <= kv_len <= T``."""
    if not 1 <= kv_len <= T:
        raise ValueError(f"flash_decode: kv_len {kv_len} outside [1, {T}]")
    bk = max(1, min(bk, T))
    return bk, -(-kv_len // bk)


def flash_decode_plain(q, k, v, kv_len: int, *, bk: int = BK):
    """Split-K decode in f32 and its merge: q [B,1,Hq,hd], cache
    [B,T,Hkv,hd] -> [B,1,Hq*hd] in q's type."""
    B, _, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    bk, ns = split_plan(T, kv_len, bk)
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
    return out.reshape(B, 1, Hq * hd).to(q.dtype)


def _launch(q, k, v, kv_len: int, bk: int) -> torch.Tensor:
    check_qkv("flash_decode", q, k, v, q_len=1)
    B, _, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"flash_decode: {Hq // Hkv} q-heads per kv-head, "
                         f"the kernel serves at most {MAX_GROUP}")
    bk, ns = split_plan(T, kv_len, bk)
    dev = q.device
    out = torch.empty((B, 1, Hq * hd), dtype=q.dtype, device=dev)
    if B == 0:
        return out
    o_part = torch.empty((B, Hq, ns, hd), dtype=torch.float32, device=dev)
    m_part = torch.empty((B, Hq, ns), dtype=torch.float32, device=dev)
    l_part = torch.empty((B, Hq, ns), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            DTYPES[q.dtype], B, Hq, Hkv, hd, kv_len, bk, ns,
            q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    STATS.launches += 1
    return out


def flash_decode(q, k, v, kv_len: int, *, bk: int = BK) -> torch.Tensor:
    """q [B,1,Hq,hd] over the first ``kv_len`` keys of the cache k/v
    [B,T,Hkv,hd] -> [B,1,Hq*hd]: the kernel for CUDA tensors, the plain
    twin for CPU tensors."""
    kv_len = int(kv_len)
    if q.is_cuda:
        return _launch(q, k, v, kv_len, bk)
    if q.device.type != "cpu":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    return flash_decode_plain(q, k, v, kv_len, bk=bk)
