"""The bf16 ``flash_attention`` tensor-core path, on the CPU: its numerics,
its gate, the wrapper's TMA alignment check and the routing by type.

The tensor-core kernel (``csrc/flash_attention.cu``, ``tc::fa_tc_kernel``)
runs only on the card (``tests/test_torch_cuda.py``).  Here a plain
emulation of its arithmetic — 128-key tiles, the online softmax in f32
with the scale folded into exp2, P rounded to bf16 before P V, the output
divided by l in f32 and rounded to bf16 — is held to
``flash_attention_plain`` within ``fa.bf16_limit`` (the gate the card
holds the kernel to), which shows that the gate's bound on the rounding of
P covers it, and to the JAX reference within the JAX sweep's bf16 2e-2.
Inputs are made with numpy from a seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(2)

BK = 128                                  # keys per K/V stage


def _qkv(seed, B, S, T, Hq, Hkv, hd, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(rng.normal(size=sh).astype(np.float32)
                                     ).to(dtype)
    return mk(B, S, Hq, hd), mk(B, T, Hkv, hd), mk(B, T, Hkv, hd)


def emulate_tc(q, k, v, *, causal=True, window=-1):
    """The tensor-core kernel's arithmetic in plain PyTorch: q [B,S,Hq,hd],
    k/v [B,T,Hkv,hd] in bf16 -> [B,S,Hq*hd] in bf16."""
    B, S, Hq, hd = q.shape
    T, G = k.shape[1], Hq // k.shape[2]
    c = torch.tensor(math.log2(math.e) / math.sqrt(hd), dtype=torch.float32)
    qf = q.float().permute(0, 2, 1, 3)                    # [B,Hq,S,hd]
    kf = k.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    rows = torch.arange(S)[:, None]
    m = torch.full((B, Hq, S), -math.inf)
    l = torch.zeros(B, Hq, S)
    o = torch.zeros(B, Hq, S, hd)
    for k0 in range(0, T, BK):
        cols = torch.arange(k0, min(k0 + BK, T))[None, :]
        vis = torch.ones(S, cols.shape[1], dtype=torch.bool)
        if causal:
            vis &= cols <= rows
        if window > 0:
            vis &= rows - cols < window
        s = qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2)  # f32 products
        s = torch.where(vis, s, -math.inf)
        x = torch.maximum(m, s.amax(-1))
        n = torch.where(x == -math.inf, 0.0, x * c)
        a = torch.exp2(m * c - n)
        p = torch.exp2(s * c - n[..., None])
        l = l * a + p.sum(-1)
        o = o * a[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + BK]
        m = x
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    out = (o * inv[..., None]).bfloat16()
    return out.permute(0, 2, 1, 3).reshape(B, S, Hq * hd)


CASES = ([(B, S, S, Hq, Hkv, hd, c, w)
          for B, S, Hq, Hkv, hd in ((1, 128, 2, 2, 64), (2, 256, 4, 2, 64),
                                    (1, 256, 8, 1, 128))
          for c, w in ((True, -1), (False, -1), (True, 96))]
         + [(2, 77, 150, 4, 4, 64, False, -1), (2, 77, 150, 4, 4, 64, True, -1),
            (1, 200, 200, 4, 2, 128, True, -1),
            (1, 200, 200, 4, 2, 128, True, 96)])


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window", CASES)
def test_tensor_core_numerics_stay_within_the_bf16_gate(B, S, T, Hq, Hkv, hd,
                                                        causal, window):
    q, k, v = _qkv(1, B, S, T, Hq, Hkv, hd)
    got = emulate_tc(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (B, S, Hq * hd)
    diff = (got.float() - want.float()).abs()
    lim = fa.bf16_limit(q, k, v, causal=causal, window=window, want=want)
    assert float((diff / lim).max()) <= 1
    # and the JAX reference at its own bf16 sweep tolerance
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    np.testing.assert_allclose(
        to_np(got.float()),
        np.asarray(ref.attention_ref(j(q), j(k), j(v), causal=causal,
                                     window=window), np.float32),
        rtol=2e-2, atol=2e-2)


def test_bf16_limit_is_the_stated_formula():
    q, k, v = _qkv(2, 1, 64, 64, 2, 1, 64)
    want = fa.flash_attention_plain(q, k, v)
    pv = fa.flash_attention_plain(q, k, v.abs()).float()
    lim = fa.bf16_limit(q, k, v)
    assert lim.dtype == torch.float32
    torch.testing.assert_close(
        lim, 1e-3 + 8e-3 * want.float().abs() + 2.0 ** -8 * pv,
        rtol=0, atol=0)


def test_tma_check_accepts_aligned_strided_views():
    q, k, v = _qkv(3, 2, 130, 130, 4, 4, 64)
    fa.check_tma("t", q, k, v)                           # contiguous
    qkv = torch.stack([q, k, v], 2)                      # [B,S,3,H,hd]
    fa.check_tma("t", *qkv.unbind(2))                    # strided views
    fa.check_tma("t", q[:, :, 1:3], k[:, :, 2:4], v[:, 3:])  # offset views
    # size-1 dims are never stepped over, so their strides do not count
    buf = torch.zeros(130 * 64, dtype=torch.bfloat16)
    odd = buf.as_strided((1, 130, 1, 64), (5, 64, 3, 1))
    fa.check_tma("t", odd, odd, odd)
    assert fa._tma_strides(odd) == (130 * 64, 64, 64)


def test_tma_check_raises_on_a_misaligned_view():
    q, k, v = _qkv(4, 1, 128, 128, 2, 2, 64)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype)
    shifted = flat[1:].view(q.shape)                     # base 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        fa.check_tma("t", shifted, k, v)
    wide = torch.zeros(1, 128, 2, 68, dtype=q.dtype)[..., :64]
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.check_tma("t", q, wide, v)                    # head stride 136 B
    rows = torch.zeros(1, 128, 2 * 64 + 4, dtype=q.dtype)[..., :128]
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.check_tma("t", q, k, rows.unflatten(2, (2, 64)))  # rows 264 B
    # check_qkv leaves TMA's alignment to check_tma
    fa.check_qkv("t", shifted, wide, v)


@pytest.mark.parametrize("dtype,path",
                         [(torch.bfloat16, "tensor_core"),
                          (torch.float32, "tensor_core_tf32x3")])
def test_routing_by_dtype(dtype, path):
    q, k, v = _qkv(5, 1, 64, 64, 2, 1, 64, dtype)
    assert fa.route(q) == path == fa.PATHS[dtype]
    before = (fa.STATS.launches, fa.STATS.tensor_core,
              fa.STATS.tensor_core_tf32x3)
    out = fa.flash_attention(q, k, v)                    # CPU: plain twin
    assert torch.equal(out, fa.flash_attention_plain(q, k, v))
    assert (fa.STATS.launches, fa.STATS.tensor_core,
            fa.STATS.tensor_core_tf32x3) == before
    with pytest.raises(TypeError):
        fa.route(q.half())
    fa.reset_launches()
    assert (fa.STATS.launches, fa.STATS.tensor_core,
            fa.STATS.tensor_core_tf32x3) == (0, 0, 0)
