"""WKV6: RWKV6's time-mix recurrence with data-dependent decay.

Port of ``repro.kernels.rwkv6_scan`` (the Pallas ``_wkv_kernel``).  The
kernel is ``csrc/wkv6.cu``: the threads of one (head, batch) walk time in
order with the state in registers, while the next tile of ``chunk`` steps
of r, k, v, w is copied into shared memory (see the source's note).  At
head dim 64 a (head, batch) is a cluster of four column-slice blocks that
share each tile by multicast; at 16 and 32 it is one block
(:func:`blocks_per_head`).  The kernel does not carry over the TPU
kernel's chunked closed form, which divides by cumulative decay products
and fails under strong decay; it computes the recurrence itself, for any
T, the single-token decode step (T = 1) included.

:func:`wkv6_plain` is the sequential recurrence in f32 (the reference's
``nn.rwkv.wkv_scan``): the kernel's oracle on the card and its path on the
CPU.  :func:`wkv6` takes the plain path only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import array
import ctypes
import functools

import torch

from . import _build

__all__ = ["wkv6", "wkv6_plain", "check_wkv", "reset_launches", "STATS",
           "SOURCE", "HEAD_DIMS", "DTYPES", "MAX_CHUNK", "ALIGN",
           "check_rows", "auto_chunk", "smem_bytes", "blocks_per_head"]

SOURCE = "wkv6"                   # csrc/wkv6.cu
HEAD_DIMS = (16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # of r, k and v
# Staged steps a tile: the double buffer of f32 r, k, v, w rows at n = 64
# (2 x 112 x 1 KB) is the most of a block's 227 KB of shared memory.
MAX_CHUNK = 112
ALIGN = 16                        # bytes: the bulk copies' rows
ROWS = 8                          # rows of S a thread holds (kRows)
SM_SMEM = 233472                  # bytes of shared memory an H100 SM has
BLOCK_SMEM_RESERVED = 1024        # ... of which each resident block costs
SM_THREADS = 2048


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
        lib.wkv6_launch.argtypes = [ctypes.c_void_p]
        lib.wkv6_launch.restype = ctypes.c_int
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


def _wkv_ok(r, k, v, w, u, s0, chunk: int) -> bool:
    """check_wkv's conditions in one pass, for the common case."""
    f32, dt, dev, sh = torch.float32, r.dtype, r.device, r.shape
    return (isinstance(k, torch.Tensor) and isinstance(v, torch.Tensor)
            and isinstance(w, torch.Tensor) and isinstance(u, torch.Tensor)
            and isinstance(s0, torch.Tensor) and dt in DTYPES
            and k.dtype is dt and v.dtype is dt and w.dtype is f32
            and u.dtype is f32 and s0.dtype is f32 and len(sh) == 4
            and k.shape == sh and v.shape == sh and w.shape == sh
            and sh[3] in HEAD_DIMS and u.shape == (sh[2], sh[3])
            and s0.shape == (sh[0], sh[2], sh[3], sh[3])
            and k.device == dev and v.device == dev and w.device == dev
            and u.device == dev and s0.device == dev
            and r.stride(3) == 1 and k.stride(3) == 1 and v.stride(3) == 1
            and w.stride(3) == 1 and u.stride(1) == 1 and s0.stride(3) == 1
            and 1 <= chunk <= MAX_CHUNK)


def check_wkv(r, k, v, w, u, s0, chunk: int) -> None:
    """Raise on inputs the kernel does not take: r, k, v [B,T,H,n] of one
    type (f32 or bf16), w [B,T,H,n], u [H,n] and s0 [B,H,n,n] in f32, all
    on one device, n in ``HEAD_DIMS``, the last dim contiguous, and
    ``1 <= chunk <= MAX_CHUNK``."""
    if isinstance(r, torch.Tensor) and _wkv_ok(r, k, v, w, u, s0, chunk):
        return
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


def blocks_per_head(n: int) -> int:
    """The kernel's blocks a (head, batch): a cluster of four 16-column
    blocks at head dim 64, one block at 16 and 32."""
    return 4 if n == 64 else 1


def _rows_ok(r, k, v, w, strides) -> bool:
    """check_rows' condition in one pass, on the strides already read.  The
    steps are powers of two, so OR-ing the values tests them all."""
    (rb, rt, rh, _), (kb, kt, kh, _), (vb, vt, vh, _), (wb, wt, wh, _) = \
        strides
    B, T, H = r.shape[:3]
    rkv = (((rb | kb | vb) if B > 1 else 0) | ((rt | kt | vt) if T > 1 else 0)
           | ((rh | kh | vh) if H > 1 else 0))
    ws = ((wb if B > 1 else 0) | (wt if T > 1 else 0)
          | (wh if H > 1 else 0))
    return not ((r.data_ptr() | k.data_ptr() | v.data_ptr() | w.data_ptr())
                % ALIGN or rkv % (ALIGN // r.element_size())
                or ws % (ALIGN // 4))


def check_rows(r, k, v, w) -> None:
    """Raise on what the card's kernel also needs: each row of r, k, v, w
    (base address, and the batch, step and head strides of dims of size
    above 1) on a 16-byte boundary, which its bulk copies need."""
    sh = r.shape
    for nm, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        st, step = t.stride(), ALIGN // t.element_size()
        if (t.data_ptr() % ALIGN or (st[0] % step and sh[0] > 1)
                or (st[1] % step and sh[1] > 1)
                or (st[2] % step and sh[2] > 1)):
            raise ValueError(f"wkv6: {nm}'s base address or strides "
                             f"{tuple(st)} are not multiples of {ALIGN} "
                             f"bytes, which the kernel's bulk copies need")


@functools.lru_cache(maxsize=1024)
def auto_chunk(B: int, H: int, n: int, itemsize: int, sms: int) -> int:
    """The default tile: the largest multiple of 16 up to MAX_CHUNK whose
    double buffer (2 x chunk steps of r, k, v rows of ``itemsize`` bytes
    and f32 w rows) still lets every one of the grid's
    ``blocks_per_head(n) * H * B`` blocks be resident at once on ``sms``
    SMs, else 16.  A longer tile means fewer barriers; a grid that does
    not fit in one wave costs more than they do."""
    cluster = blocks_per_head(n)
    per_sm = -(-cluster * H * B // sms)
    threads = (n // cluster) * (n // ROWS)
    for chunk in range(MAX_CHUNK // 16 * 16, 16, -16):
        smem = smem_bytes(chunk, n, itemsize) + BLOCK_SMEM_RESERVED
        if per_sm * smem <= SM_SMEM and per_sm * threads <= SM_THREADS:
            return chunk
    return 16


def smem_bytes(chunk: int, n: int, itemsize: int) -> int:
    """A block's shared memory, as csrc/wkv6.cu's ``smem_bytes`` counts it:
    the double buffer of ``chunk`` steps of r, k, v (``itemsize`` bytes)
    and f32 w rows, and two mbarriers."""
    return 2 * chunk * n * (3 * itemsize + 4) + 16


def _launch(r, k, v, w, u, s0, chunk: int | None):
    check_wkv(r, k, v, w, u, s0, MAX_CHUNK if chunk is None else chunk)
    B, T, H, n = r.shape
    strides = rs, ks, vs, ws = r.stride(), k.stride(), v.stride(), w.stride()
    if not _rows_ok(r, k, v, w, strides):
        check_rows(r, k, v, w)
    index = r.get_device()
    if chunk is None:
        chunk = auto_chunk(B, H, n, r.element_size(), _build.sm_count(index))
    y = r.new_empty((B, T, H, n), dtype=torch.float32)
    sT = r.new_empty((B, H, n, n), dtype=torch.float32)
    if B == 0 or H == 0:
        return y, sT
    ss = s0.stride()
    args = array.array("q", (
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
        DTYPES[r.dtype], B, T, H, n, chunk, rs[0], rs[1], rs[2],
        ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], ws[0], ws[1], ws[2],
        u.stride(0), ss[0], ss[1], ss[2], index,
        torch._C._cuda_getCurrentRawStream(index)))
    rc = _lib().wkv6_launch(args.buffer_info()[0])
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    STATS.launches += 1
    return y, sT


def wkv6(r, k, v, w, u, s0, *, chunk: int | None = None):
    """r, k, v, w [B,T,H,n]; u [H,n]; s0 [B,H,n,n] -> (y [B,T,H,n], sT
    [B,H,n,n]), both f32: the kernel for CUDA tensors (``chunk`` steps
    staged in shared memory at a time, :func:`auto_chunk` unless given; the
    result does not depend on it), the plain twin for CPU tensors.  Any T
    is taken, 1 (a decode step) and 0 included.  Refuses inputs that
    require grad under grad mode (:func:`_build.refuse_grad`)."""
    _build.refuse_grad("wkv6", r, k, v, w, u, s0)
    if r.is_cuda:
        return _launch(r, k, v, w, u, s0, chunk)
    check_wkv(r, k, v, w, u, s0, MAX_CHUNK if chunk is None else chunk)
    if r.device.type != "cpu":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    return wkv6_plain(r, k, v, w, u, s0)
