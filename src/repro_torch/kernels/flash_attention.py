"""Flash attention: blocked online-softmax attention, causal + sliding
window + GQA, for uncached full sequences (scoring, training, a prompt of
latent attention).

Port of ``repro.kernels.flash_attention`` (the Pallas ``_fa_kernel``).
The kernels are in ``csrc/flash_attention.cu`` (see the source's note), one
per input type:

- bf16 takes the **tensor-core** path: one CTA per (128 query rows,
  q-head, batch), a producer warpgroup feeding a TMA ring of K/V tiles and
  two consumer warpgroups running both products on ``wgmma``, P in bf16
  registers.  Besides q/k and v of one head dim it takes latent
  attention's q/k 192 and v 128 (DeepSeek-V3's prompt, ``nn.mla``).
- f32 takes the **3xTF32 tensor-core** path: one CTA of two warpgroups
  per (128 query rows, q-head, batch), a two-stage TMA ring of 32-key K/V
  tiles, a split pass that turns each tile into TF32 ``hi + lo`` halves
  (V transposed), and both products on ``wgmma`` TF32 summed as ``hi lo +
  lo hi + hi hi``, which holds the f32 gate that one TF32 product misses.

``HEAD_DIMS`` holds each path's (q/k, v) head-dim pairs.  Both read the
JAX layout ``[B, S, H, hd]`` through TMA, so both need
16-byte-aligned base addresses and strides, which :func:`check_tma`
checks (an input that fails raises), and both mask a ragged S or T edge,
so unlike the reference they need no padding and write every row.
``STATS.launches`` counts every launch, ``STATS.tensor_core`` and
``STATS.tensor_core_tf32x3`` each path's, ``STATS.tensor_core_192_128``
the bf16 path's at (192, 128).

:func:`flash_attention_plain` is the same function in plain PyTorch
(masked dense softmax in f32): the kernels' oracle on the card and their
path on the CPU.  :func:`flash_attention` takes the plain path only for
tensors on the CPU; for CUDA tensors it launches a kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .dense_attention import attend_dense

__all__ = ["flash_attention", "flash_attention_plain", "check_qkv",
           "check_tma", "route", "tc_info", "tf32_info", "bf16_limit",
           "reset_launches", "STATS", "SOURCE", "HEAD_DIMS", "DTYPES",
           "PATHS"]

SOURCE = "flash_attention"        # csrc/flash_attention.cu
# (q/k, v) head-dim pairs each path's kernel is built at
HEAD_DIMS = {torch.bfloat16: ((64, 64), (128, 128), (192, 128)),
             torch.float32: ((64, 64), (128, 128))}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = {torch.bfloat16: "tensor_core", torch.float32: "tensor_core_tf32x3"}
TMA_ALIGN = 16                    # bytes: TMA's base address and strides
# the launch functions' return codes past CUDA's own
_NO_ENTRY_POINT, _MAP_ERROR = 10000, 20000


class _Stats:
    """Launch counts: all launches, and each path's."""

    def __init__(self):
        self.launches = 0
        self.tensor_core = 0
        self.tensor_core_tf32x3 = 0
        self.tensor_core_192_128 = 0       # of tensor_core: latent attention


STATS = _Stats()


def reset_launches() -> None:
    STATS.launches = STATS.tensor_core = STATS.tensor_core_tf32x3 = 0
    STATS.tensor_core_192_128 = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.flash_attention_tf32_launch,
                   lib.flash_attention_tc_launch):
            fn.argtypes = [vp] * 4 + [ci] * 7 + [ll] * 9 + [ci] * 2 + [vp]
            fn.restype = ci
        lib.flash_attention_tc_info.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.flash_attention_tf32_info.argtypes = [ci, ctypes.POINTER(ci)]
        for fn in (lib.flash_attention_tc_info, lib.flash_attention_tf32_info):
            fn.restype = ci
        lib._argtypes_set = True
    return lib


def tc_info(hd: int, hv: int | None = None) -> dict:
    """The tensor-core kernel's launch shape at head dims (``hd``, ``hv``)
    (``hv`` defaults to ``hd``), as the built library reports it."""
    hv = hd if hv is None else hv
    buf = (ctypes.c_int * 5)()
    rc = _lib().flash_attention_tc_info(hd, hv, buf)
    if rc != 0:
        raise ValueError(f"flash_attention: head dims {(hd, hv)} not in "
                         f"{HEAD_DIMS[torch.bfloat16]}")
    return dict(zip(("threads", "producer_regs", "consumer_regs", "stages",
                     "smem_bytes"), buf))


def tf32_info(hd: int) -> dict:
    """The 3xTF32 kernel's launch shape at head dim ``hd``, as the built
    library reports it."""
    buf = (ctypes.c_int * 4)()
    rc = _lib().flash_attention_tf32_info(hd, buf)
    if rc != 0:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS[torch.float32]}")
    return dict(zip(("threads", "keys", "stages", "smem_bytes"), buf))


def route(q: torch.Tensor) -> str:
    """The kernel path a CUDA tensor of q's type takes: ``"tensor_core"``
    for bf16, ``"tensor_core_tf32x3"`` for f32."""
    if q.dtype not in PATHS:
        raise TypeError(f"flash_attention: no kernel for dtype {q.dtype}")
    return PATHS[q.dtype]


def _tma_strides(t: torch.Tensor) -> tuple:
    """t's (batch, row, head) strides in elements, with the stride of a
    size-1 dim (never stepped over) replaced by its contiguous value."""
    B, L, H, hd = t.shape
    dense = (L * H * hd, H * hd, hd)
    return tuple(t.stride(i) if t.shape[i] > 1 else dense[i]
                 for i in range(3))


def check_tma(name: str, q, k, v) -> None:
    """Raise unless q, k and v can be read by TMA: each base address and
    each stride that is stepped over a multiple of 16 bytes."""
    for nm, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}: {nm}'s base address is not "
                             f"{TMA_ALIGN}-byte aligned, which the "
                             f"tensor-core kernels' TMA loads need")
        bad = [s for s in _tma_strides(t) if (s * size) % TMA_ALIGN]
        if bad:
            raise ValueError(f"{name}: {nm}'s strides {tuple(t.stride())} "
                             f"are not all multiples of {TMA_ALIGN} bytes, "
                             f"which the tensor-core kernels' TMA loads "
                             f"need")


def check_qkv(name: str, q, k, v, *, q_len: int | None = None) -> None:
    """Raise on inputs the attention kernels do not take: q [B,S,Hq,hd],
    k [B,T,Hkv,hd] and v [B,T,Hkv,hv] on one device, one type (f32 or
    bf16), (hd, hv) one of the type's ``HEAD_DIMS``, Hq a multiple of Hkv,
    the head dim contiguous."""
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
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if q_len is not None and S != q_len:
        raise ValueError(f"{name}: q must hold {q_len} token(s), has {S}")
    dims = HEAD_DIMS[q.dtype]
    if (hd, v.shape[3]) not in dims:
        raise ValueError(f"{name}: head dims (q/k, v) {(hd, v.shape[3])} "
                         f"not in {dims} for {q.dtype}")
    if Hq % k.shape[2]:
        raise ValueError(f"{name}: {Hq} q-heads are not a multiple of "
                         f"{k.shape[2]} kv-heads")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int = -1) -> torch.Tensor:
    """Masked dense softmax attention in f32 (``dense_attention.attend_dense``
    over the whole sequence): q [B,S,Hq,hd], k [B,T,Hkv,hd], v [B,T,Hkv,hv]
    -> [B,S,Hq*hv] in q's type."""
    return attend_dense(q, k, v, causal=causal, window=window)


def bf16_limit(q, k, v, *, causal: bool = True, window: int = -1,
               want: torch.Tensor | None = None) -> torch.Tensor:
    """The elementwise limit on |kernel - plain| for bf16 inputs, in f32:
    ``1e-3 + 8e-3 |plain| + 2^-8 plain(q, k, |v|)``.  The first two terms
    allow one bf16 rounding of each side's output; the last is the bound
    u * sum_j p_j |v_j| / l on rounding P to bf16 (unit roundoff u = 2^-8)
    before P V, which the tensor-core kernel does and the plain twin does
    not.  ``want`` is the plain output, if already computed."""
    if want is None:
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
    pv = flash_attention_plain(q, k, v.abs(), causal=causal, window=window)
    return 1e-3 + 8e-3 * want.float().abs() + 2.0 ** -8 * pv.float()


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    check_qkv("flash_attention", q, k, v)
    path = route(q)
    check_tma("flash_attention", q, k, v)
    B, S, Hq, hd = q.shape
    T, Hkv, hv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, S, Hq * hv), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out
    if T == 0:
        raise ValueError("flash_attention: no keys to attend over")
    lib = _lib()
    fn = (lib.flash_attention_tc_launch if path == "tensor_core"
          else lib.flash_attention_tf32_launch)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, T, Hq, Hkv, hd, hv, *_tma_strides(q),
                *_tma_strides(k), *_tma_strides(v), int(causal), int(window),
                stream)
    if rc != 0:
        if rc == _NO_ENTRY_POINT:
            why = "cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled"
        elif rc >= _MAP_ERROR:
            why = f"cuTensorMapEncodeTiled gave CUresult {rc - _MAP_ERROR}"
        else:
            why = f"CUDA error {rc}"
        raise RuntimeError(f"flash_attention {path} kernel launch failed: "
                           f"{why}")
    STATS.launches += 1
    setattr(STATS, path, getattr(STATS, path) + 1)
    if (hd, hv) == (192, 128):
        STATS.tensor_core_192_128 += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int = -1) -> torch.Tensor:
    """q [B,S,Hq,hd], k [B,T,Hkv,hd], v [B,T,Hkv,hv] -> [B,S,Hq*hv]: the
    kernel for CUDA tensors, the plain twin for CPU tensors.  ``window <=
    0`` is full attention; any S and T are taken (no padding).  Refuses
    inputs that require grad under grad mode (:func:`_build.refuse_grad`)."""
    _build.refuse_grad("flash_attention", q, k, v)
    if q.is_cuda:
        return _launch(q, k, v, causal, int(window))
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, window=window)

