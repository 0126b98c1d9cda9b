"""Flash attention: blocked online-softmax attention, causal + sliding
window + GQA, for uncached full sequences (scoring, training).

Port of ``repro.kernels.flash_attention`` (the Pallas ``_fa_kernel``).
The kernel is ``csrc/flash_attention.cu``: one CUDA block per (tile of 64
query rows, q-head, batch) sweeping the 64-key K/V tiles of its kv-head
that the causal and window rules leave, with the running max, sum and
accumulator in registers (see the source's note).  It reads the JAX layout
``[B, S, H, hd]`` through strides and masks a ragged S or T edge, so unlike
the reference it needs no padding and writes every row.

:func:`flash_attention_plain` is the same function in plain PyTorch
(masked dense softmax in f32): the kernel's oracle on the card and its
path on the CPU.  :func:`flash_attention` takes the plain path only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .dense_attention import attend_dense

__all__ = ["flash_attention", "flash_attention_plain", "check_qkv",
           "reset_launches", "STATS", "SOURCE", "HEAD_DIMS", "DTYPES"]

SOURCE = "flash_attention"        # csrc/flash_attention.cu
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Stats:
    """Launch count of the kernel."""

    def __init__(self):
        self.launches = 0


STATS = _Stats()


def reset_launches() -> None:
    STATS.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = ([vp] * 4 + [ci] * 7 +
                                               [ll] * 9 + [ci] * 2 + [vp])
        lib.flash_attention_launch.restype = ci
        lib._argtypes_set = True
    return lib


def check_qkv(name: str, q, k, v, *, q_len: int | None = None) -> None:
    """Raise on inputs the attention kernels do not take: q [B,S,Hq,hd] and
    k/v [B,T,Hkv,hd] on one device, one type (f32 or bf16), hd 64 or 128,
    Hq a multiple of Hkv, the head dim contiguous."""
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name}: {nm} must be a 4-d tensor "
                             f"[B, S, H, hd]")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: {nm} has dtype {t.dtype}; the kernel "
                            f"takes {sorted(map(str, DTYPES))}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {nm} is {t.dtype} on {t.device}, q "
                             f"is {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {nm}'s head dim must be contiguous")
    B, S, Hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if q_len is not None and S != q_len:
        raise ValueError(f"{name}: q must hold {q_len} token(s), has {S}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if Hq % k.shape[2]:
        raise ValueError(f"{name}: {Hq} q-heads are not a multiple of "
                         f"{k.shape[2]} kv-heads")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int = -1) -> torch.Tensor:
    """Masked dense softmax attention in f32 (``dense_attention.attend_dense``
    over the whole sequence): q [B,S,Hq,hd], k/v [B,T,Hkv,hd] ->
    [B,S,Hq*hd] in q's type."""
    return attend_dense(q, k, v, causal=causal, window=window)


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    check_qkv("flash_attention", q, k, v)
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, S, Hq * hd), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out
    if T == 0:
        raise ValueError("flash_attention: no keys to attend over")
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, S, T, Hq, Hkv, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    STATS.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int = -1) -> torch.Tensor:
    """q [B,S,Hq,hd], k/v [B,T,Hkv,hd] -> [B,S,Hq*hd]: the kernel for CUDA
    tensors, the plain twin for CPU tensors.  ``window <= 0`` is full
    attention; any S and T are taken (no padding)."""
    if q.is_cuda:
        return _launch(q, k, v, causal, int(window))
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, window=window)

