"""Port parity: the attention kernels' plain twins and ``attend`` against
the JAX reference.

``flash_attention_plain`` is held to ``repro.kernels.ref.attention_ref``
(the reference's Pallas ``flash_attention`` does not run in interpret mode
on this JAX, so it is never the oracle); ``flash_decode_plain`` to
``ref.decode_ref`` and to the reference's Pallas ``flash_decode`` in
interpret mode.  Shapes are the JAX sweep's (``tests/test_kernels.py``),
with its tolerances: 2e-5 (f32) and 2e-2 (bf16), relative and absolute.
Inputs are made with numpy and rounded to the working type once, in f32,
before both packages see them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from repro.kernels import ops, ref
from repro.nn.attention import attend as jattend
from repro_torch.kernels import flash_attention as fa, flash_decode as fd
from repro_torch.nn import attention as tatt

DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, dtype="float32"):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    x = rng.normal(size=shape).astype(np.float32)
    tdt, jdt = DT[dtype]
    return torch.as_tensor(x).to(tdt), jnp.asarray(x).astype(jdt)


def _qkv(seed, B, S, T, Hq, Hkv, hd, dtype="float32"):
    rng = np.random.default_rng(seed)
    return (_pair(rng, (B, S, Hq, hd), dtype),
            _pair(rng, (B, T, Hkv, hd), dtype),
            _pair(rng, (B, T, Hkv, hd), dtype))


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(to_np(got.float()),
                               np.asarray(want, np.float32), **_tol(dtype))


# -- flash_attention_plain ---------------------------------------------------

@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [
    (1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, -1), (False, -1),
                                           (True, 96)])
def test_flash_attention_plain_matches_reference(B, S, Hq, Hkv, hd, dtype,
                                                 causal, window):
    (tq, jq), (tk, jk), (tv, jv) = _qkv(1, B, S, S, Hq, Hkv, hd, dtype)
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == DT[dtype][0] and got.shape == (B, S, Hq * hd)
    _close(got, ref.attention_ref(jq, jk, jv, causal=causal, window=window),
           dtype)


@pytest.mark.parametrize("S,T,causal,window", [
    (200, 200, True, -1), (1151 // 8, 1151 // 8, True, 96),
    (77, 150, False, -1), (77, 150, True, -1)])
def test_flash_attention_plain_ragged_shapes(S, T, causal, window):
    """S and T that are not multiples of the kernel's 64-row tiles (the
    reference kernel leaves such tail rows unwritten)."""
    (tq, jq), (tk, jk), (tv, jv) = _qkv(2, 2, S, T, 8, 2, 64)
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    _close(got, ref.attention_ref(jq, jk, jv, causal=causal, window=window))


def test_cpu_wrappers_run_the_plain_twins_and_count_no_launch():
    (tq, _), (tk, _), (tv, _) = _qkv(3, 1, 64, 64, 4, 2, 64)
    before = (fa.STATS.launches, fd.STATS.launches)
    assert torch.equal(fa.flash_attention(tq, tk, tv),
                       fa.flash_attention_plain(tq, tk, tv))
    assert torch.equal(fd.flash_decode(tq[:, :1], tk, tv, 40, bk=16),
                       fd.flash_decode_plain(tq[:, :1], tk, tv, 40, bk=16))
    assert (fa.STATS.launches, fd.STATS.launches) == before


def test_check_qkv_rejects_what_the_kernels_do_not_take():
    (tq, _), (tk, _), (tv, _) = _qkv(4, 1, 8, 8, 4, 2, 64)
    fa.check_qkv("t", tq, tk, tv)                         # accepted
    with pytest.raises(ValueError, match="head dim"):
        fa.check_qkv("t", tq[..., :32], tk[..., :32], tv[..., :32])
    with pytest.raises(TypeError):
        fa.check_qkv("t", tq.double(), tk.double(), tv.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_qkv("t", tq.transpose(2, 3).contiguous().transpose(2, 3),
                     tk, tv)
    with pytest.raises(ValueError, match="multiple"):
        fa.check_qkv("t", tq[:, :, :3], tk, tv)
    with pytest.raises(ValueError, match="token"):
        fa.check_qkv("t", tq, tk, tv, q_len=1)
    with pytest.raises(ValueError):
        fa.check_qkv("t", tq, tk[:, :4], tv)


def test_check_qkv_takes_the_latent_pair_in_bf16_only():
    """(q/k 192, v 128) is a pair of the bf16 kernel's, not of the f32
    one's; q and k share a depth, and v k's batch, keys and heads."""
    def mk(*sh):
        return torch.zeros(sh, dtype=torch.bfloat16)
    q, k, v = mk(2, 8, 4, 192), mk(2, 8, 4, 192), mk(2, 8, 4, 128)
    fa.check_qkv("t", q, k, v)                            # accepted
    assert (192, 128) in fa.HEAD_DIMS[torch.bfloat16]
    assert (192, 128) not in fa.HEAD_DIMS[torch.float32]
    with pytest.raises(ValueError, match="head dims"):
        fa.check_qkv("t", q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head dims"):
        fa.check_qkv("t", q, k, mk(2, 8, 4, 64))          # (192, 64)
    with pytest.raises(ValueError, match="head dims"):
        fa.check_qkv("t", mk(2, 8, 4, 96), mk(2, 8, 4, 96), mk(2, 8, 4, 64))
    with pytest.raises(ValueError, match="head dims"):
        fd.check_decode(q[:, :1], k, v)                   # not flash_decode's
    with pytest.raises(ValueError, match="do not match"):
        fa.check_qkv("t", q, mk(2, 8, 4, 128), v)         # k's depth
    with pytest.raises(ValueError, match="do not match"):
        fa.check_qkv("t", q, k, mk(2, 9, 4, 128))         # v's keys


def test_attend_kernel_takes_the_latent_pair_uncached_only():
    """``attend(impl="kernel")`` sends uncached bf16 q/k 192 and v 128 to
    ``flash_attention`` (its plain twin on the CPU, so the dense result
    bit for bit), and refuses the pair over a cache, in f32 and at a pair
    no kernel takes, counting no route."""
    from repro_torch.runtime import obs
    g = torch.Generator().manual_seed(0)

    def mk(hd, dtype=torch.bfloat16):
        return torch.randn(1, 9, 2, hd, generator=g).to(dtype)
    q, k, v = mk(192), mk(192), mk(128)
    obs.reset()
    got = tatt.attend(q, k, v, impl="kernel")
    assert obs.counters().get("attend.flash_attention") == 1
    assert got.shape == (1, 9, 256)
    assert torch.equal(got, tatt.attend(q, k, v, impl="dense"))
    obs.reset()
    for args, kw in (((q, k, v), dict(kv_len=9)),
                     ((q, k, v), dict(q_offset=2, kv_len=9)),
                     ((q.float(), k.float(), v.float()), {}),
                     ((q, k, mk(64)), {}), ((q, mk(128), v), {})):
        with pytest.raises(ValueError, match="no kernel takes"):
            tatt.attend(*args, impl="kernel", **kw)
    assert not [c for c in obs.counters() if c.startswith("attend.")]


# -- flash_decode_plain --------------------------------------------------------

@pytest.mark.parametrize("B,T,Hq,Hkv,hd,kv_len", [
    (1, 1024, 4, 4, 64, 800), (2, 2048, 8, 2, 64, 2048),
    (1, 1024, 8, 1, 128, 513),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_reference(B, T, Hq, Hkv, hd, kv_len,
                                              dtype):
    (tq, jq), (tk, jk), (tv, jv) = _qkv(5, B, 1, T, Hq, Hkv, hd, dtype)
    got = fd.flash_decode_plain(tq, tk, tv, kv_len, bk=256)
    assert got.dtype == DT[dtype][0] and got.shape == (B, 1, Hq * hd)
    _close(got, ref.decode_ref(jq, jk, jv, kv_len), dtype)
    _close(got, ops.flash_decode(jq, jk, jv, kv_len, bk=256,
                                 interpret=True), dtype)


@pytest.mark.parametrize("kv_len,bk", [(72, 512), (50, 32), (7, 16)])
def test_flash_decode_plain_clamps_and_pads(kv_len, bk):
    """bk > T and T % bk != 0 clamp and pad instead of dropping tail keys
    (the reference's test_flash_decode_cache_not_multiple_of_block)."""
    (tq, jq), (tk, jk), (tv, jv) = _qkv(6, 1, 1, 72, 4, 2, 32)
    got = fd.flash_decode_plain(tq, tk, tv, kv_len, bk=bk)
    _close(got, ref.decode_ref(jq, jk, jv, kv_len))
    _close(got, ops.flash_decode(jq, jk, jv, kv_len, bk=bk, interpret=True))
    assert fd.split_plan(72, kv_len, bk) == (min(bk, 72),
                                             -(-kv_len // min(bk, 72)))


def test_flash_decode_plain_ignores_a_poisoned_tail():
    """Keys past kv_len hold +-1e6 (the reference's
    test_attend_pallas_cached_decode_masks_tail poison): a split wholly
    past kv_len adds exactly nothing."""
    kv_len = 37
    (tq, jq), (tk, jk), (tv, jv) = _qkv(7, 2, 1, 160, 4, 2, 16)
    want = ref.decode_ref(jq, jk, jv, kv_len)
    tk[:, kv_len:], tv[:, kv_len:] = 1e6, -1e6
    for bk in (16, 64, 512):
        got = fd.flash_decode_plain(tq, tk, tv, kv_len, bk=bk)
        assert torch.isfinite(got).all()
        _close(got, want)
    with pytest.raises(ValueError, match="kv_len"):
        fd.flash_decode_plain(tq, tk, tv, 0)
    with pytest.raises(ValueError, match="kv_len"):
        fd.flash_decode_plain(tq, tk, tv, 161)


# -- attend: the math and the dispatch ----------------------------------------

@pytest.mark.parametrize("S,T,Hq,Hkv,window,q_offset,kv_len,q_chunk", [
    (40, 40, 4, 2, -1, 0, None, 512),        # uncached, GQA
    (40, 40, 4, 4, 16, 0, None, 512),        # sliding window
    (3, 60, 4, 2, -1, 14, 17, 512),          # cache append mid-cache
    (1, 60, 8, 2, -1, 36, 37, 512),          # single-token decode
    (1, 60, 8, 2, 8, 36, 37, 512),           # windowed decode
    (70, 90, 4, 2, 24, 10, 80, 32),          # chunked, cached, windowed
    (600, 600, 4, 2, -1, 0, None, 512),      # chunked (S > q_chunk)
])
def test_attend_dense_matches_reference(S, T, Hq, Hkv, window, q_offset,
                                        kv_len, q_chunk):
    (tq, jq), (tk, jk), (tv, jv) = _qkv(8, 2, S, T, Hq, Hkv, 16)
    kw = dict(causal=True, window=window, q_offset=q_offset, kv_len=kv_len,
              q_chunk=q_chunk)
    got = tatt.attend(tq, tk, tv, impl="dense", **kw)
    _close(got, jattend(jq, jk, jv, impl="xla", **kw))


class _Spy:
    """Records the calls to a kernel wrapper and runs it."""

    def __init__(self, monkeypatch, mod, name):
        self.calls, self.fn = [], getattr(mod, name)
        monkeypatch.setattr(mod, name, self)

    def __call__(self, *args, **kw):
        self.calls.append((args[3:], kw))
        return self.fn(*args, **kw)


@pytest.fixture
def spies(monkeypatch):
    return (_Spy(monkeypatch, fa, "flash_attention"),
            _Spy(monkeypatch, fd, "flash_decode"))


def test_kernel_dispatch_uncached_goes_to_flash_attention(spies):
    sfa, sfd = spies
    (tq, _), (tk, _), (tv, _) = _qkv(9, 2, 40, 40, 4, 2, 16)
    got = tatt.attend(tq, tk, tv, window=16, impl="kernel")
    assert len(sfa.calls) == 1 and not sfd.calls
    assert sfa.calls[0][1] == dict(causal=True, window=16)
    assert torch.equal(got, fa.flash_attention_plain(tq, tk, tv, window=16))


@pytest.mark.parametrize("q_offset,kv_len,want", [(36, 37, 37), (20, 37, 21)])
def test_kernel_dispatch_single_token_goes_to_flash_decode(spies, q_offset,
                                                           kv_len, want):
    """A last-token and a mid-cache query: flash_decode sees
    min(kv_len, q_offset + 1) keys, so it masks as the dense path does."""
    sfa, sfd = spies
    (tq, _), (tk, _), (tv, _) = _qkv(10, 2, 1, 60, 8, 2, 16)
    got = tatt.attend(tq, tk, tv, q_offset=q_offset, kv_len=kv_len,
                      impl="kernel")
    assert not sfa.calls and len(sfd.calls) == 1
    assert sfd.calls[0][0] == (want,)
    dense = tatt.attend(tq, tk, tv, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(to_np(got), to_np(dense), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("S,window,kv_len", [(2, -1, 2), (3, -1, 17),
                                             (3, -1, 60), (1, 8, 37),
                                             (1, 0, 37)])
def test_kernel_dispatch_other_cached_calls_take_dense_math(spies, S, window,
                                                            kv_len):
    """Multi-token appends (a prefill, the DT's 2-3 token steps) and
    windowed decodes take the dense math, bit-equal to impl="dense"."""
    sfa, sfd = spies
    (tq, _), (tk, _), (tv, _) = _qkv(11, 2, S, 60, 4, 2, 16)
    kw = dict(window=window, q_offset=kv_len - S, kv_len=kv_len)
    got = tatt.attend(tq, tk, tv, impl="kernel", **kw)
    assert not sfa.calls and not sfd.calls
    assert torch.equal(got, tatt.attend(tq, tk, tv, impl="dense", **kw))


def test_attend_rejects_unknown_impl():
    (tq, _), (tk, _), (tv, _) = _qkv(12, 1, 4, 4, 2, 2, 16)
    with pytest.raises(ValueError, match="impl"):
        tatt.attend(tq, tk, tv, impl="xla")
