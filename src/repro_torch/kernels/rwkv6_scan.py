"""WKV6: RWKV6's time-mix recurrence with data-dependent decay.

Port of ``repro.kernels.rwkv6_scan`` (the Pallas ``_wkv_kernel``).  The
kernel is ``csrc/wkv6.cu``: one CUDA block per (slice of value columns,
head, batch) walks time in order with its columns of the state in
registers (see the source's note).  It does not carry over the TPU
kernel's chunked closed form, which divides by cumulative decay products
and fails under strong decay; it computes the recurrence itself.

:func:`wkv6_plain` is the sequential recurrence in f32 (the reference's
``nn.rwkv.wkv_scan``): the kernel's oracle on the card, its path on the
CPU, and the port's single-token decode step.  :func:`wkv6` takes the
plain path only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["wkv6", "wkv6_plain", "check_wkv", "reset_launches", "STATS",
           "SOURCE", "HEAD_DIMS", "DTYPES", "MAX_CHUNK"]

SOURCE = "wkv6"                   # csrc/wkv6.cu
HEAD_DIMS = (16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # of r, k and v
MAX_CHUNK = 256                   # staged steps: 208 KB of shared memory


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
        lib.wkv6_launch.argtypes = ([vp] * 8 + [ci] * 6 + [ll] * 16 + [vp])
        lib.wkv6_launch.restype = ci
        lib._argtypes_set = True
    return lib


def wkv6_plain(r, k, v, w, u, s0):
    """The sequential WKV6 recurrence in f32.  r, k, v, w [B,T,H,n]; u
    [H,n]; s0 [B,H,n,n] -> (y [B,T,H,n], sT [B,H,n,n])."""
    rs, ks, vs, ws = (t.float() for t in (r, k, v, w))
    uf = u.float()[..., None]
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = ks[:, t, :, :, None] * vs[:, t, :, None, :]      # [B,H,n,n]
        ys.append(torch.einsum("bhi,bhij->bhj", rs[:, t], uf * kv + s))
        s = ws[:, t, :, :, None] * s + kv
    return torch.stack(ys, 1), s


def check_wkv(r, k, v, w, u, s0, chunk: int) -> None:
    """Raise on inputs the kernel does not take: r, k, v [B,T,H,n] of one
    type (f32 or bf16), w [B,T,H,n], u [H,n] and s0 [B,H,n,n] in f32, all
    on one device, n in ``HEAD_DIMS``, the last dim contiguous, and
    ``1 <= chunk <= MAX_CHUNK``."""
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0))
    for nm, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"wkv6: {nm} must be a tensor")
        if t.device != r.device:
            raise ValueError(f"wkv6: {nm} is on {t.device}, r on {r.device}")
        if t.numel() and t.stride(-1) != 1:
            raise ValueError(f"wkv6: {nm}'s last dim must be contiguous")
    if r.dtype not in DTYPES:
        raise TypeError(f"wkv6: r has dtype {r.dtype}; the kernel takes "
                        f"{sorted(map(str, DTYPES))}")
    for nm, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise TypeError(f"wkv6: {nm} is {t.dtype}, r is {r.dtype}")
    for nm, t in (("w", w), ("u", u), ("s0", s0)):
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6: {nm} must be float32, is {t.dtype}")
    if r.dim() != 4:
        raise ValueError("wkv6: r must be a 4-d tensor [B, T, H, n]")
    B, T, H, n = r.shape
    for nm, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {nm} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}")
    if u.shape != (H, n) or s0.shape != (B, H, n, n):
        raise ValueError(f"wkv6: u {tuple(u.shape)} / s0 {tuple(s0.shape)} "
                         f"do not match r {tuple(r.shape)}")
    if n not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {n}; the kernel takes {HEAD_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"wkv6: chunk {chunk} outside [1, {MAX_CHUNK}]")


def _launch(r, k, v, w, u, s0, chunk: int):
    B, T, H, n = r.shape
    dev = r.device
    y = torch.empty((B, T, H, n), dtype=torch.float32, device=dev)
    sT = torch.empty((B, H, n, n), dtype=torch.float32, device=dev)
    if B == 0 or H == 0:
        return y, sT
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
            DTYPES[r.dtype], B, T, H, n, chunk,
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], u.stride(0), *s0.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    STATS.launches += 1
    return y, sT


def wkv6(r, k, v, w, u, s0, *, chunk: int = 64):
    """r, k, v, w [B,T,H,n]; u [H,n]; s0 [B,H,n,n] -> (y [B,T,H,n], sT
    [B,H,n,n]), both f32: the kernel for CUDA tensors (``chunk`` steps
    staged in shared memory at a time; the result does not depend on it),
    the plain twin for CPU tensors."""
    check_wkv(r, k, v, w, u, s0, chunk)
    if r.is_cuda:
        return _launch(r, k, v, w, u, s0, chunk)
    if r.device.type != "cpu":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    return wkv6_plain(r, k, v, w, u, s0)
