"""Port parity for the decode-side kernels' redesign: the ``flash_decode``
split plan sized to the card, plain emulations of the arithmetic order of
the ``flash_decode`` and ``wkv6`` kernels held to their plain twins, the
wrappers' checks of what the card's kernels need, and the RWKV decode step
routed to ``wkv6`` under ``impl="kernel"``, and the softmax statistics
that ``flash_decode(stats=True)`` returns for the sequence-parallel merge.

The twins run on the CPU.  ``flash_decode_plain`` under the card's plan is
held to the reference's ``ref.decode_ref`` and its Pallas
``flash_decode`` in interpret mode (at the reference's own split size,
512) within the JAX sweep's 2e-5 + 2e-5 (f32).  The emulations repeat
each kernel's order of operations in f32 (an FMA as one rounding of the
exact product and sum) and are held to the twins within the kernels'
gates: 2e-5 + 2e-5 for ``flash_decode``; for ``wkv6`` 5e-5 + 5e-5 on y and
``torch.equal`` on sT, which the kernel computes with the twin's
roundings.  The statistics: the twin's log-sum-exp against one in f64,
the kernel order's against the twin's, and the merge
(``distributed.tp.merge_partials``) of 2, 4 and 16 key shards, one of
them with no visible key, against the unsharded call, at G 1, 4, 5, 8 and
16, within the same gate; the dense route's ``attend_stats`` likewise,
windowed.  Inputs are made with numpy from a seed.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from repro.kernels import ops, ref
from repro_torch.distributed import tp
from repro_torch.kernels import flash_decode as fd, rwkv6_scan as rk
from repro_torch.kernels.dense_attention import attend_dense, attend_stats
from repro_torch.nn import RWKVBlock
from repro_torch.nn import rwkv as trwkv

FD_TOL = dict(rtol=2e-5, atol=2e-5)
WKV_TOL = dict(rtol=5e-5, atol=5e-5)
H100_SMS = 132
SERVE = dict(B=4, T=1160, Hq=32, Hkv=8, hd=128)      # qwen3_8b serving
SWEEP = [(1, 1024, 4, 4, 64, 800), (2, 2048, 8, 2, 64, 2048),
         (1, 1024, 8, 1, 128, 513)]                 # tests/test_kernels.py


def _qkv(seed, B, T, Hq, Hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=sh).astype(np.float32)
                 for sh in ((B, 1, Hq, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))


def _card_bk(B, T, Hkv, kv_len):
    return fd.split_plan(T, kv_len, None, sms=H100_SMS, rows=Hkv * B)[0]


# -- the split plan -----------------------------------------------------------

@pytest.mark.parametrize("kv_len", [1025, 1088, 1151])
def test_card_plan_fills_the_card_at_the_serving_shape(kv_len):
    B, T, Hkv = SERVE["B"], SERVE["T"], SERVE["Hkv"]
    bk, ns = fd.split_plan(T, kv_len, None, sms=H100_SMS, rows=Hkv * B)
    assert bk % fd.BK_STEP == 0 and fd.BK_STEP <= bk <= fd.BK
    assert ns == -(-kv_len // bk) and ns * Hkv * B >= 2 * H100_SMS
    # the largest such bk: one step up falls short of two blocks per SM
    if bk < fd.BK:
        up = bk + fd.BK_STEP
        assert -(-kv_len // up) * Hkv * B < 2 * H100_SMS
    assert (bk, ns) == (128, 9)


@pytest.mark.parametrize("bk", [16, 32, 256, 512])
def test_explicit_bk_is_honoured(bk):
    T, kv_len = SERVE["T"], 1088
    want = (min(bk, T), -(-kv_len // min(bk, T)))
    assert fd.split_plan(T, kv_len, bk, sms=H100_SMS, rows=32) == want
    assert fd.split_plan(T, kv_len, bk) == want
    q, k, _ = (torch.as_tensor(a) for a in _qkv(0, 4, T, 32, 8, 128))
    assert fd.plan(q, k, kv_len, bk) == want


def test_cpu_tensors_take_the_reference_split_size():
    q, k, _ = (torch.as_tensor(a) for a in _qkv(0, 1, 1024, 4, 4, 64))
    assert fd.plan(q, k, 800) == fd.split_plan(1024, 800) == (512, 2)
    assert fd.split_plan(72, 50, None) == (72, 1)     # clamped to the cache


@pytest.mark.parametrize("kv_len,want", [(1, 64), (40, 64), (4096, 512)])
def test_card_plan_edges(kv_len, want):
    """Short caches fall back to the smallest split; a batch that fills
    the card on its own keeps the reference's 512."""
    bk, _ = fd.split_plan(4096, kv_len, None, sms=H100_SMS,
                          rows=1 if kv_len < 4096 else 264)
    assert bk == want


@pytest.mark.parametrize("T,kv_len,B,Hq,Hkv,want", [
    (524288, 524288, 4, 25, 5, (1024, 512)),    # hymba_15b, long_500k: G 5
    (524288, 524288, 1, 25, 5, (1024, 512)),
    (262144, 262144, 4, 64, 4, (1024, 256)),    # qwen3_moe_235b: G 16
    (131072, 131072, 4, 64, 4, (512, 256)),
    (524288, 500001, 4, 64, 4, (1984, 253)),
    (2097152, 2097152, 1, 32, 8, (4096, 512))])
def test_card_plan_grows_bk_for_a_long_cache(T, kv_len, B, Hq, Hkv, want):
    """Past ``limits(G)``'s split count at 512 keys a split, the card's
    plan takes the least multiple of 64 that the kernel's merge can stage,
    so a decode the reference serves is not refused."""
    G = Hq // Hkv
    max_bk, max_ns = fd.limits(G)
    bk, ns = fd.split_plan(T, kv_len, None, sms=H100_SMS, rows=Hkv * B,
                           group=G)
    assert (bk, ns) == want and ns == -(-kv_len // bk)
    assert bk % fd.BK_STEP == 0 and bk <= max_bk and ns <= max_ns
    if bk > fd.BK:                      # one step less needs too many splits
        assert -(-kv_len // (bk - fd.BK_STEP)) > max_ns
    q = torch.zeros(B, 1, Hq, 64)
    k = torch.zeros(B, 1, Hkv, 64).expand(B, T, Hkv, 64)
    assert fd.plan(q, k, kv_len) == fd.split_plan(T, kv_len) == (512, -(
        -kv_len // 512))                # CPU tensors keep the reference's
    # a cache past what the largest split covers: the plan says so, and the
    # launch raises on it
    assert fd.split_plan(600000, 600000, None, sms=H100_SMS, rows=4,
                         group=16)[0] > fd.limits(16)[0]


# -- flash_decode_plain under the card's plan --------------------------------

@pytest.mark.parametrize("B,T,Hq,Hkv,hd,kv_len", SWEEP + [
    (1, 1024, 8, 2, 64, 1), (2, 1024, 8, 2, 64, 1024),
    (SERVE["B"], SERVE["T"], 8, 2, 64, 1088)])
def test_plain_under_card_plan_matches_reference(B, T, Hq, Hkv, hd, kv_len):
    q, k, v = _qkv(1, B, T, Hq, Hkv, hd)
    bk = _card_bk(B, T, Hkv, kv_len)
    got = fd.flash_decode_plain(*map(torch.as_tensor, (q, k, v)), kv_len,
                                bk=bk)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(to_np(got), np.asarray(
        ref.decode_ref(jq, jk, jv, kv_len)), **FD_TOL)
    np.testing.assert_allclose(to_np(got), np.asarray(
        ops.flash_decode(jq, jk, jv, kv_len, interpret=True)), **FD_TOL)


# -- flash_decode: the kernel's arithmetic order ------------------------------

def _fma(a, b, c):
    """f32 a * b + c with one rounding (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(x, dim):
    """The xor-shuffle sum over ``dim`` (a power of two) as lane 0 ends
    it: halves added pairwise, the lower half first."""
    while x.shape[dim] > 1:
        lo, hi = x.chunk(2, dim)
        x = lo + hi
    return x.squeeze(dim)


def _fd_emulated(q, k, v, kv_len, bk):
    """flash_decode as csrc/flash_decode.cu orders it, in f32: per split,
    each score a sum of 4 lanes' chunk-strided partials (chunks of 4 f32,
    lane p taking chunks p, p+4, ...) finished by 2 shuffles; the split's
    exact max; p summed lane-strided over 32 lanes then by shuffles; P V
    accumulated by kSets key sets (key j in set j % kSets; 4 warps, each
    taking 32 / (hd / 4) keys a step) added in order; then the splits
    merged in split order."""
    B, _, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    sets = 4 * (32 // (hd // 4))     # f32: 4 warps x keys a warp step
    ns = -(-kv_len // bk)
    scale = torch.tensor(1.0, dtype=torch.float32) / torch.sqrt(
        torch.tensor(float(hd), dtype=torch.float32))
    qg = q.reshape(B, Hkv, G, hd)
    o_s, m_s, l_s = [], [], []
    for s in range(ns):
        kk = k[:, s * bk:min((s + 1) * bk, kv_len)].permute(0, 2, 1, 3)
        vv = v[:, s * bk:min((s + 1) * bk, kv_len)].permute(0, 2, 1, 3)
        n = kk.shape[2]                        # [B, Hkv, n, hd]
        lanes = torch.zeros(4, B, Hkv, G, n)
        for p in range(4):
            for c in range(p, hd // 4, 4):
                for e in range(4):
                    d = 4 * c + e
                    lanes[p] = _fma(qg[..., d, None], kk[:, :, None, :, d],
                                    lanes[p])
        sc = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) * scale
        m = sc.amax(-1)                        # [B, Hkv, G]
        p_ = torch.exp(sc - m[..., None])
        lane_sum = torch.zeros(32, B, Hkv, G)
        for j in range(n):
            lane_sum[j % 32] += p_[..., j]
        l = _butterfly(lane_sum, 0)
        o = torch.zeros(sets, B, Hkv, G, hd)
        for j in range(n):
            o[j % sets] = _fma(p_[..., j, None], vv[:, :, None, j], o[j % sets])
        acc = o[0]
        for st in range(1, sets):
            acc = acc + o[st]
        o_s.append(acc)
        m_s.append(m)
        l_s.append(l)
    mg = torch.stack(m_s).amax(0)
    acc, den = torch.zeros_like(o_s[0]), torch.zeros_like(l_s[0])
    for o, m, l in zip(o_s, m_s, l_s):
        w = torch.exp(m - mg)
        den = den + w * l
        acc = acc + o * w[..., None]
    out = acc / torch.clamp_min(den, 1e-30)[..., None]
    return out.reshape(B, 1, Hq * hd), (mg + torch.log(den)).reshape(B, Hq)


@pytest.mark.parametrize("B,T,Hq,Hkv,hd,kv_len,bk", [
    (2, 300, 8, 2, 128, 300, None), (1, 200, 4, 1, 64, 77, None),
    (2, 256, 16, 2, 64, 129, 64), (1, 96, 2, 2, 128, 96, 32),
    (1, 160, 16, 1, 128, 150, 64), (2, 100, 25, 5, 64, 100, None)])
def test_flash_decode_kernel_order_holds_the_twin(B, T, Hq, Hkv, hd, kv_len,
                                                  bk):
    q, k, v = map(torch.as_tensor, _qkv(2, B, T, Hq, Hkv, hd))
    if bk is None:
        bk = _card_bk(B, T, Hkv, kv_len)
    got, lse = _fd_emulated(q, k, v, kv_len, bk)
    want, wlse = fd.flash_decode_plain(q, k, v, kv_len, bk=bk, stats=True)
    torch.testing.assert_close(got, want, **FD_TOL)
    torch.testing.assert_close(lse, wlse, **FD_TOL)


# -- flash_decode: the softmax statistics and the shard merge ------------------

STATS_G = [(8, 8), (8, 2), (25, 5), (64, 8), (64, 4)]     # G 1, 4, 5, 8, 16


def _lse64(q, k, kv_len):
    """[B, Hq] log-sum-exp of the scaled scores over the first kv_len keys,
    in f64."""
    B, _, Hq, hd = q.shape
    G = Hq // k.shape[2]
    kk = k[:, :kv_len].double().repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bthd->bht", q[:, 0].double(), kk) / np.sqrt(hd)
    return torch.logsumexp(s, -1)


@pytest.mark.parametrize("Hq,Hkv", STATS_G)
@pytest.mark.parametrize("kv_len", [1, 300, 1088])
def test_plain_stats_match_f64(Hq, Hkv, kv_len):
    q, k, v = map(torch.as_tensor, _qkv(3, 2, 1160, Hq, Hkv, 64))
    out, lse = fd.flash_decode_plain(q, k, v, kv_len, stats=True)
    torch.testing.assert_close(lse.double(), _lse64(q, k, kv_len),
                               **FD_TOL)
    torch.testing.assert_close(out, fd.flash_decode_plain(q, k, v, kv_len))


def _shards(q, k, v, kv_len, R, *, dtype=torch.float32):
    """flash_decode with statistics over R contiguous shards of the
    cache's positions, each over its visible keys, merged."""
    B, _, Hq, hd = q.shape
    Tl = k.shape[1] // R
    outs, lses = [], []
    for r in range(R):
        seen = min(max(kv_len - r * Tl, 0), Tl)
        o, l = fd.flash_decode(q.to(dtype), k[:, r * Tl:(r + 1) * Tl]
                               .to(dtype), v[:, r * Tl:(r + 1) * Tl]
                               .to(dtype), seen, stats=True)
        outs.append(o.reshape(B, Hq, hd))
        lses.append(l)
    return tp.merge_partials(torch.stack(outs), torch.stack(lses)).reshape(
        B, 1, Hq * hd)


@pytest.mark.parametrize("Hq,Hkv", STATS_G)
@pytest.mark.parametrize("R", [2, 4, 16])
def test_shard_merge_equals_the_unsharded_call(Hq, Hkv, R):
    """kv_len 700 of T 1152: with R 2 the last shard is partly seen, with
    4 and 16 some shards hold no visible key (output 0, lse -inf)."""
    q, k, v = map(torch.as_tensor, _qkv(4, 2, 1152, Hq, Hkv, 64))
    got = _shards(q, k, v, 700, R)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, fd.flash_decode(q, k, v, 700),
                               **FD_TOL)


def test_a_shard_with_no_visible_key():
    q, k, v = map(torch.as_tensor, _qkv(5, 2, 64, 8, 2, 64))
    out, lse = fd.flash_decode(q, k, v, 0, stats=True)
    assert (out == 0).all() and torch.isneginf(lse).all()
    with pytest.raises(ValueError, match="kv_len 0"):
        fd.flash_decode(q, k, v, 0)
    both = tp.merge_partials(torch.stack([out.reshape(2, 8, 64)] * 2),
                             torch.stack([lse] * 2))
    assert (both == 0).all()           # no part saw a key: 0, not NaN


@pytest.mark.parametrize("window", [-1, 40])
def test_attend_stats_shards_merge_to_attend_dense(window):
    """The dense route's statistics (a windowed decode, a prefill-sized
    block of queries) over 4 shards of the keys, merged, equal
    ``attend_dense`` over all of them."""
    rng = np.random.default_rng(6)
    q = torch.as_tensor(rng.normal(size=(2, 5, 8, 32)).astype(np.float32))
    k = torch.as_tensor(rng.normal(size=(2, 96, 2, 32)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=(2, 96, 2, 32)).astype(np.float32))
    idx = 80                           # the queries sit at 80..84
    want = attend_dense(q, k, v, window=window, q_offset=idx, kv_len=idx + 5)
    outs, lses = [], []
    for r in range(4):
        o, l = attend_stats(q, k[:, r * 24:(r + 1) * 24],
                            v[:, r * 24:(r + 1) * 24], window=window,
                            q_offset=idx - r * 24,
                            kv_len=min(max(idx + 5 - r * 24, 0), 24),
                            q_chunk=2)
        outs.append(o)
        lses.append(l)
    got = tp.merge_partials(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(got.reshape(want.shape), want, **FD_TOL)
    o, l = attend_stats(q, k, v, window=window, q_offset=idx,
                        kv_len=idx + 5)
    B, S, Hq, hd = q.shape
    G = Hq // k.shape[2]
    kk = k.double().repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bsht", q.double(), kk) / np.sqrt(hd)
    i = torch.arange(S)[:, None] + idx
    j = torch.arange(96)[None, :]
    ok = (j <= i) & (j < idx + 5) & ((i - j < window) if window > 0 else True)
    s = torch.where(ok[None, :, None, :], s, float("-inf"))
    torch.testing.assert_close(l.double(), torch.logsumexp(s, -1), **FD_TOL)


# -- flash_decode: what the card's kernel needs --------------------------------

def _misaligned(shape):
    """A float32 tensor of ``shape`` whose base is 4 bytes off 16."""
    flat = torch.zeros(int(np.prod(shape)) + 1)
    return flat[1:].view(shape)


def test_decode_check_refuses_what_the_kernel_does_not_take():
    q, k, v = map(torch.as_tensor, _qkv(3, 1, 64, 4, 2, 64))
    fd.check_decode(q, k, v)                              # accepted
    with pytest.raises(ValueError, match="16 bytes"):
        fd.check_decode(q, _misaligned(k.shape), v)
    with pytest.raises(ValueError, match="16 bytes"):
        fd.check_decode(q, k, torch.zeros(1, 64, 2, 66)[..., :64])
    fd.check_decode(torch.zeros(1, 1, 16, 64), k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError, match="at most"):
        fd.check_decode(torch.zeros(1, 1, 17, 64), k[:, :, :1],
                        v[:, :, :1])
    with pytest.raises(ValueError, match="head dim"):
        fd.check_decode(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="token"):
        fd.check_decode(torch.zeros(1, 2, 4, 64), k, v)
    with pytest.raises(TypeError):
        fd.check_decode(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fd.check_decode(q, k, v.double().float()[:, :32])


# -- wkv6: the kernel's arithmetic order --------------------------------------

def _wkv(seed, B, T, H, n, decay):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.as_tensor(rng.normal(size=(B, T, H, n)),
                               dtype=torch.float32) for _ in range(3))
    w = torch.as_tensor(rng.uniform(*decay, size=(B, T, H, n)),
                        dtype=torch.float32)
    u = torch.as_tensor(rng.normal(size=(H, n)), dtype=torch.float32)
    s0 = torch.as_tensor(rng.normal(size=(B, H, n, n)), dtype=torch.float32)
    return r, k, v, w, u, s0


WKV_ROWS = rk.ROWS    # rows of S a thread of csrc/wkv6.cu holds


def test_wkv_rows_match_the_kernel_source():
    src = (rk._build.CSRC / "wkv6.cu").read_text()
    assert re.search(r"constexpr int kRows = (\d+);", src).group(1) == \
        str(rk.ROWS)


def _wkv_emulated(r, k, v, w, u, s0):
    """wkv6 as csrc/wkv6.cu orders it, in f32: RG = n / WKV_ROWS threads a
    value column, thread g holding the rows of the 16-byte chunks g, g +
    RG, ... (VEC elements each); its WKV_ROWS terms of y go into 4 partial
    sums, term ii into sum ii % 4, added as (s0 + s1) + (s2 + s3), and the
    RG threads' sums by a shuffle butterfly; S is updated as the twin
    does."""
    B, T, H, n = r.shape
    RG = n // WKV_ROWS
    VEC = 16 // r.element_size()
    rows = [[(g + RG * (ii // VEC)) * VEC + ii % VEC
             for ii in range(WKV_ROWS)] for g in range(RG)]
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf, S = u.float(), s0.float().clone()
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # [B,H,n,n]
        parts = []
        for g in range(RG):
            acc = [torch.zeros(B, H, n) for _ in range(4)]
            for ii, i in enumerate(rows[g]):
                term = uf[None, :, i, None] * kv[:, :, i] + S[:, :, i]
                acc[ii % 4] = _fma(rf[:, t, :, i, None], term, acc[ii % 4])
            parts.append((acc[0] + acc[1]) + (acc[2] + acc[3]))
        ys.append(_butterfly(torch.stack(parts), 0))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, 1), S


@pytest.mark.parametrize("B,T,H,n,decay", [
    (2, 1, 3, 64, (0.75, 0.9995)), (1, 1, 2, 16, (0.05, 0.3)),
    (2, 67, 2, 64, (0.05, 0.3)), (1, 40, 2, 32, (0.05, 0.3)),
    (1, 130, 1, 64, (0.75, 0.9995)), (2, 33, 2, 16, (0.75, 0.9995))])
def test_wkv6_kernel_order_holds_the_twin(B, T, H, n, decay):
    ins = _wkv(4, B, T, H, n, decay)
    y, sT = _wkv_emulated(*ins)
    want_y, want_s = rk.wkv6_plain(*ins)
    assert torch.equal(sT, want_s)
    torch.testing.assert_close(y, want_y, **WKV_TOL)


def test_wkv6_kernel_order_holds_the_twin_in_bf16():
    r, k, v, w, u, s0 = _wkv(5, 1, 50, 2, 64, (0.05, 0.3))
    r, k, v = (t.bfloat16() for t in (r, k, v))
    y, sT = _wkv_emulated(r, k, v, w, u, s0)
    want_y, want_s = rk.wkv6_plain(r, k, v, w, u, s0)
    assert torch.equal(sT, want_s)
    torch.testing.assert_close(y, want_y, **WKV_TOL)


# -- wkv6: what the card's kernel needs ---------------------------------------

def test_max_chunk_double_buffer_fits_a_block():
    """MAX_CHUNK is the largest multiple of 16 whose double buffer fits a
    block in f32 at n = 64."""
    assert rk.smem_bytes(rk.MAX_CHUNK, 64, 4) <= 232448
    assert rk.smem_bytes(rk.MAX_CHUNK + 16, 64, 4) > 232448
    assert rk.smem_bytes(32, 64, 4) == 2 * 32 * 1024 + 16
    assert [rk.blocks_per_head(n) for n in rk.HEAD_DIMS] == [1, 1, 4]
    ins = _wkv(6, 1, 4, 2, 16, (0.75, 0.9995))
    with pytest.raises(ValueError, match="chunk"):
        rk.wkv6(*ins, chunk=rk.MAX_CHUNK + 1)
    rk.wkv6(*ins, chunk=rk.MAX_CHUNK)


@pytest.mark.parametrize("B,H,n,itemsize,want", [
    (2, 40, 64, 4, 32),       # rwkv6_3b scoring in f32: 320 blocks, 3 an SM
    (4, 40, 64, 4, 16),       # the serving prefill: 640 blocks, 5 an SM
    (2, 40, 64, 2, 48),       # scoring in bf16: half the r, k, v bytes
    (2, 40, 32, 4, 112),      # n 32, one block a (head, batch): 80 blocks
    (64, 40, 64, 4, 16)])     # more blocks than fit at once: the least
def test_auto_chunk_keeps_the_grid_resident(B, H, n, itemsize, want):
    chunk = rk.auto_chunk(B, H, n, itemsize, H100_SMS)
    assert chunk == want and chunk % 16 == 0 and chunk <= rk.MAX_CHUNK
    per_sm = -(-rk.blocks_per_head(n) * H * B // H100_SMS)
    smem = lambda c: rk.smem_bytes(c, n, itemsize) + 1024
    if want > 16:
        assert per_sm * smem(chunk) <= rk.SM_SMEM
    if want < rk.MAX_CHUNK // 16 * 16:
        assert per_sm * smem(chunk + 16) > rk.SM_SMEM or want == 16


def test_wkv6_row_check_refuses_what_the_kernel_does_not_take():
    r, k, v, w, u, s0 = _wkv(7, 1, 8, 2, 64, (0.75, 0.9995))
    rk.check_rows(r, k, v, w)
    rk.check_rows(r[..., :32], k[..., :32], v[..., :32], w[..., :32])
    with pytest.raises(ValueError, match="16 bytes"):
        rk.check_rows(_misaligned(r.shape), k, v, w)
    with pytest.raises(ValueError, match="16 bytes"):
        rk.check_rows(r, k, v, torch.zeros(1, 8, 2, 65)[..., :64])


def _rows(layout, dtype):
    """r, k, v (``dtype``) and w (f32) [2, T, 3, 64] in ``layout``: views
    of one buffer padded by ``pad`` elements a row, offset ``off`` elements
    from its base, with T steps (a step of size 1 may have any stride)."""
    T, pad, off, w_pad = layout
    buf = torch.zeros(2 * T * 3 * (64 + pad) + off, dtype=dtype)
    rkv = buf[off:].view(2, T, 3, 64 + pad)[..., :64]
    wb = torch.zeros(2 * T * 3 * (64 + w_pad)).view(2, T, 3, 64 + w_pad)
    return rkv, rkv, rkv, wb[..., :64]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [
    (8, 0, 0, 0), (1, 0, 0, 0), (8, 4, 0, 0), (8, 8, 0, 4), (8, 2, 0, 0),
    (8, 0, 4, 0), (8, 0, 1, 0), (1, 2, 0, 0), (8, 0, 0, 2), (8, 0, 0, 1)])
def test_wkv6_row_fast_check_agrees_with_check_rows(dtype, layout):
    """The wrapper's one-pass row test (``_rows_ok``) accepts exactly what
    ``check_rows`` accepts: aligned and misaligned bases, padded rows,
    bf16's 8-element steps, w's own 4-element step, a step dim of size 1."""
    r, k, v, w = _rows(layout, dtype)
    strides = tuple(t.stride() for t in (r, k, v, w))
    try:
        rk.check_rows(r, k, v, w)
        taken = True
    except ValueError:
        taken = False
    assert rk._rows_ok(r, k, v, w, strides) == taken


# -- the RWKV decode step's routing -------------------------------------------

class _Count:
    def __init__(self, monkeypatch, name):
        self.n, self.fn = 0, getattr(trwkv, name)
        monkeypatch.setattr(trwkv, name, self)

    def __call__(self, *args, **kw):
        self.n += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("impl,T", [("kernel", 1), ("dense", 1),
                                    ("kernel", 5), ("dense", 5)])
def test_time_mix_routing(monkeypatch, impl, T):
    """impl="kernel" sends every time mix to rwkv6_scan.wkv6, the decode
    step (T = 1) included; impl="dense" sends T = 1 to wkv_scan and T > 1
    to wkv_chunked."""
    torch.manual_seed(0)
    block = RWKVBlock(64, n_heads=4, head_dim=16, d_ff=128,
                      generator=torch.Generator().manual_seed(0))
    kernel, scan = _Count(monkeypatch, "wkv6"), _Count(monkeypatch,
                                                       "wkv_scan")
    chunked = _Count(monkeypatch, "wkv_chunked")
    assert kernel.fn is rk.wkv6 and scan.fn is rk.wkv6_plain
    x = torch.as_tensor(np.random.default_rng(8).normal(size=(2, T, 64)),
                        dtype=torch.float32)
    state = {"s": torch.zeros(2, 4, 16, 16), "x_tm": torch.zeros(2, 64),
             "xc_tm": torch.zeros(2, 64)}
    with torch.no_grad():             # the kernel has no backward
        out, new = block(x, state=state, impl=impl)
    want = (1, 0, 0) if impl == "kernel" else ((0, 1, 0) if T == 1
                                               else (0, 0, 1))
    assert (kernel.n, scan.n, chunked.n) == want
    assert out.shape == x.shape and new["s"].shape == (2, 4, 16, 16)
