"""The f32 ``flash_attention`` path (3xTF32 on the tensor cores), on the
CPU: its arithmetic against the f32 gate, the JAX reference and an f64
attention.

The kernel (``csrc/flash_attention.cu``, ``tf::fa_tf32_kernel``) runs only
on the card (``tests/test_torch_cuda.py``).  Here a plain emulation of its
arithmetic — each operand split into TF32 halves ``hi = rna(x)``, ``lo =
rna(x - hi)`` (``rna``: round to nearest, ties away, by integer rounding of
the f32 bits), each 8-wide k-step of a product summed as ``hi lo + lo hi``
and then ``hi hi``, over 16 columns of hd in Q K^T and over one 32-key
tile in P V before it joins its f32 accumulator, the online softmax in f32
over 32-key tiles with the scale folded into exp2 — is held to
``flash_attention_plain`` within the card's f32 gate, 2e-5 + 2e-5 |plain|
(the JAX sweep's), and to the JAX reference within the same.  At large
scores (q and k scaled by 4 and 8) no f32 kernel holds that gate against
the plain twin, which is as far from the exact answer; there the
emulation's error against an f64 attention must stay within twice the
twin's own.  The same emulation with
one TF32 product (no split) misses the gate, so the gate can tell the two
apart.  Inputs are made with numpy from a seed.
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

BK = 32                                   # keys per K/V stage
HD_STEP = 16                              # hd columns a Q K^T run sums
K_STEP = 8                                # the mma's k
RTOL = ATOL = 2e-5                        # the f32 gate


def _qkv(seed, B, S, T, Hq, Hkv, hd, scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.normal(size=sh).astype(np.float32)
    q, k, v = mk(B, S, Hq, hd), mk(B, T, Hkv, hd), mk(B, T, Hkv, hd)
    q, k = (q * np.float32(scale)), (k * np.float32(scale))
    return tuple(torch.as_tensor(x) for x in (q, k, v))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10 fraction bits, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: add half a TF32 ulp to
    the bits and clear the 13 dropped ones."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """x = hi + lo, both TF32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a, b, products: int):
    """a @ b as the kernel forms it: over k-steps of K_STEP, ``(a_lo b_hi +
    a_hi b_lo) + a_hi b_hi`` (products 3), or one TF32 product ``rna(a)
    rna(b)`` (products 1)."""
    if products == 1:
        return tf32_rna(a) @ tf32_rna(b)
    ah, al = split(a)
    bh, bl = split(b)
    out = 0.0
    for k0 in range(0, a.shape[-1], K_STEP):
        ks = slice(k0, k0 + K_STEP)
        small = al[..., ks] @ bh[..., ks, :] + ah[..., ks] @ bl[..., ks, :]
        out = out + (small + ah[..., ks] @ bh[..., ks, :])
    return out


def emulate_tf32x3(q, k, v, *, causal=True, window=-1, products=3):
    """The 3xTF32 kernel's arithmetic in plain PyTorch: q [B,S,Hq,hd], k/v
    [B,T,Hkv,hd] in f32 -> [B,S,Hq*hd] in f32."""
    B, S, Hq, hd = q.shape
    T, G = k.shape[1], Hq // k.shape[2]
    c = torch.tensor(math.log2(math.e) / math.sqrt(hd), dtype=torch.float32)
    qf = q.permute(0, 2, 1, 3)                            # [B,Hq,S,hd]
    kf = k.repeat_interleave(G, 2).permute(0, 2, 1, 3)
    vf = v.repeat_interleave(G, 2).permute(0, 2, 1, 3)
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
        kt = kf[:, :, k0:k0 + BK].transpose(-1, -2)      # [B,Hq,hd,keys]
        s = torch.zeros(B, Hq, S, cols.shape[1])
        for d0 in range(0, hd, HD_STEP):
            s = s + product(qf[..., d0:d0 + HD_STEP],
                            kt[..., d0:d0 + HD_STEP, :], products)
        s = torch.where(vis, s, -math.inf)
        x = torch.maximum(m, s.amax(-1))
        n = torch.where(x == -math.inf, 0.0, x * c)
        a = torch.exp2(m * c - n)
        p = torch.exp2(s * c - n[..., None])
        l = l * a + p.sum(-1)
        o = o * a[..., None] + product(p, vf[:, :, k0:k0 + BK], products)
        m = x
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    out = o * inv[..., None]
    return out.permute(0, 2, 1, 3).reshape(B, S, Hq * hd)


def attention_f64(q, k, v, *, causal=True, window=-1):
    """Masked dense softmax attention in f64: the exact answer to f32's
    precision, for measuring each side's own error."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.double().reshape(B, S, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.double()) / math.sqrt(hd)
    i, j = torch.arange(S)[:, None], torch.arange(T)[None, :]
    ok = torch.ones(S, T, dtype=torch.bool)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= i - j < window
    p = torch.softmax(torch.where(ok, s, -math.inf), -1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.double())
    return out.reshape(B, S, Hq * hd)


def gate_ratio(got, want) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 holds the gate."""
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


CASES = ([(B, S, S, Hq, Hkv, hd, c, w)
          for B, S, Hq, Hkv, hd in ((1, 128, 2, 2, 64), (2, 256, 4, 2, 64),
                                    (1, 256, 8, 1, 128))
          for c, w in ((True, -1), (False, -1), (True, 96))]
         + [(2, 77, 150, 4, 4, 64, False, -1),
            (2, 77, 150, 4, 4, 64, True, -1),
            (1, 200, 200, 4, 2, 128, True, -1),
            (1, 200, 200, 4, 2, 128, True, 96)])


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window", CASES)
def test_tf32x3_numerics_hold_the_f32_gate(B, S, T, Hq, Hkv, hd, causal,
                                           window):
    q, k, v = _qkv(1, B, S, T, Hq, Hkv, hd)
    got = emulate_tf32x3(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (B, S, Hq * hd)
    assert gate_ratio(got, want) <= 1
    # and the JAX reference at its own f32 sweep tolerance
    j = lambda t: jnp.asarray(t.numpy())
    np.testing.assert_allclose(
        to_np(got), np.asarray(ref.attention_ref(j(q), j(k), j(v),
                                                 causal=causal,
                                                 window=window), np.float32),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", [4.0, 8.0])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal", [
    (1, 256, 4, 1, 128, True), (1, 200, 2, 2, 64, False)])
def test_tf32x3_is_as_exact_as_f32_at_large_scores(B, S, Hq, Hkv, hd, causal,
                                                   scale):
    """q and k scaled by 4 and 8 (scores of std ~16 and ~32 before the
    1/sqrt(hd) scale): against an f64 attention, the emulation errs at
    most twice as much as the plain twin."""
    q, k, v = _qkv(2, B, S, S, Hq, Hkv, hd, scale)
    exact = attention_f64(q, k, v, causal=causal)
    twin = fa.flash_attention_plain(q, k, v, causal=causal).double()
    got = emulate_tf32x3(q, k, v, causal=causal).double()
    twin_err = float((twin - exact).abs().max())
    got_err = float((got - exact).abs().max())
    assert twin_err > 0
    assert got_err <= 2 * twin_err, (got_err, twin_err)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [(1, 256, 4, 1, 128),
                                           (2, 128, 2, 2, 64)])
def test_one_tf32_product_misses_the_gate(B, S, Hq, Hkv, hd):
    """Without the split (one TF32 product in each of Q K^T and P V) the
    same emulation is far outside the gate, and 3xTF32 far inside."""
    q, k, v = _qkv(3, B, S, S, Hq, Hkv, hd)
    want = fa.flash_attention_plain(q, k, v)
    one = gate_ratio(emulate_tf32x3(q, k, v, products=1), want)
    three = gate_ratio(emulate_tf32x3(q, k, v), want)
    assert one > 5, one
    assert three < 0.5, three


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                      # TF32's ulp at 1.0
    x = torch.tensor([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2),
                      1.0 + ulp / 2 - 2.0 ** -23, 1.0 + 0.75 * ulp,
                      3.0e-3, 0.0], dtype=torch.float32)
    got = tf32_rna(x)
    want = torch.tensor([1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp,
                         float(np.float32(3.0e-3)), 0.0])
    assert torch.equal(got[:5], want[:5])
    assert got[6] == 0
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # the split is exact: hi + lo == x to the 22 bits the two carry
    y = torch.as_tensor(np.random.default_rng(4).normal(size=1000)
                        .astype(np.float32))
    hi, lo = split(y)
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2.0 ** -21
    assert float((lo.abs() / y.abs()).max()) <= 2.0 ** -11


def test_f32_routes_to_the_tf32x3_path():
    q, k, v = _qkv(5, 1, 64, 64, 2, 1, 64)
    assert fa.route(q) == "tensor_core_tf32x3" == fa.PATHS[torch.float32]
    before = (fa.STATS.launches, fa.STATS.tensor_core_tf32x3)
    out = fa.flash_attention(q, k, v)                    # CPU: plain twin
    assert torch.equal(out, fa.flash_attention_plain(q, k, v))
    assert (fa.STATS.launches, fa.STATS.tensor_core_tf32x3) == before
