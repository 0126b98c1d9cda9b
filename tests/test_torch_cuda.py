"""Checks of the port that need a CUDA card: each kernel (``fusion_eval``,
``flash_attention``, ``flash_decode``, ``wkv6``) against its plain twin,
and the paths through them.  Each skips without a card (decided inside the
fixture, never at import).  The file imports nothing of JAX, of the
reference package or of the CPU parity helpers, so it runs on a machine
that has only PyTorch.  On the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import accel, cost_model as cm, gsampler as gs
from repro_torch.kernels import flash_attention as fa, flash_decode as fd
from repro_torch.kernels import fusion_eval as fe, rwkv6_scan as rk
from repro_torch.models import lm, rwkv_lm
from repro_torch.workloads import resnet18, tiny_cnn
from repro_torch.workloads.grid import paper_grid

pytestmark = pytest.mark.cuda
MB = 2.0 ** 20


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fe.compiled_backend_supported()
    return torch.device("cuda", torch.cuda.current_device())


def _grid(dev, pop, nmax):
    """The smoke grid's conditions (6 CNNs x 5 parts x 4 budgets) whose net
    fits ``nmax`` (all 120 at 64; at 32 and 19, one chunk of 32 positions,
    the 60 of vgg16, resnet18 and tiny_cnn, at 19 resnet18's n 18 =
    nmax - 1), or
    at nmax 54 mnasnet alone (n 53 = nmax - 1), packed for edge and served
    on each part, ``pop`` strategies a condition from no SYNC to all
    SYNC."""
    parts = sorted(accel.ACCEL_ZOO)
    conds, works, batches, budgets = paper_grid(parts, (8, 16, 32, 64), 32)
    if nmax == 54:
        keep = [conds.index(("mnasnet", "datacenter", 8))]
    else:
        keep = [i for i, w in enumerate(works) if w.n < nmax]
    wl = cm.stack_workloads([cm.pack_workload(works[i], accel.PAPER_ACCEL,
                                              nmax, device=dev)
                             for i in keep])
    hw = accel.stack_hw([accel.ACCEL_ZOO[conds[i][1]] for i in keep],
                        len(keep), dev)
    rng = np.random.default_rng(pop)
    s = torch.as_tensor(np.stack([np.stack([
        cm.random_strategy(rng, works[i].n, nmax, 32,
                           p_sync=(0.0, 0.2, 0.4, 0.7, 1.0)[j % 5])
        for j in range(pop)]) for i in keep]), device=dev)
    return (wl, s, torch.as_tensor(batches[keep], device=dev),
            torch.as_tensor(budgets[keep], device=dev), hw)


@pytest.mark.parametrize("form", list(fe.Form), ids=lambda f: f.name)
@pytest.mark.parametrize("pop", [1, 36, 40, 133])
@pytest.mark.parametrize("nmax", [54, 64, 32, 19])
def test_kernel_bit_equal_to_plain_twin(dev, form, pop, nmax):
    """Every output of every form, CostOut included, bit for bit, at one
    condition (nmax 54) and at grids of two chunks of 32 positions (64)
    and of one (32, 19); ``gid`` under the mask (past n the kernel and the
    twin both hold the SYNC count, which the repair never reads)."""
    wl, s, batches, budgets, hw = _grid(dev, pop, nmax)
    args = fe.kernel_args(wl, s, batches, hw)
    before = fe.STATS.launches
    got = fe.fusion_eval(form, args, budgets)
    assert fe.STATS.launches == before + 1
    want = fe.fusion_eval_plain(form, *args, budgets)
    assert len(got) == len(want) == {fe.Form.COST: 1, fe.Form.STATS: 3,
                                     fe.Form.RAW: 8}[form]
    for k in want[0]._fields:
        assert torch.equal(getattr(got[0], k), getattr(want[0], k)), k
    mask = wl["mask"][:, None, :].expand_as(s)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.int32:
            assert torch.equal(g[mask], w[mask])
        else:
            assert torch.equal(g, w)
    if form == fe.Form.RAW:
        raw = fe.fusion_eval_raw(*args)
        assert all(torch.equal(g, w) for g, w in zip(raw[:6], got[1:7]))


@pytest.mark.parametrize("stats", [False, True])
def test_evaluate_grid_is_one_kernel_launch(dev, stats):
    """One evaluation is one CUDA kernel, counted with the profiler as
    ``profile_main_path`` counts: the CostOut reduction runs in it."""
    wl, s, batches, budgets, hw = _grid(dev, 40, 64)
    fn = cm.evaluate_grid_stats if stats else cm.evaluate_grid
    fn(wl, s, batches, budgets, hw)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = fe.STATS.launches
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn(wl, s, batches, budgets, hw)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert fe.STATS.launches == before + 3
    assert len(kernels) == 3, [e.name for e in kernels]
    assert all("fusion_eval" in e.name for e in kernels)


def test_gsampler_on_card_is_deterministic_and_uses_kernel(dev):
    cfg = gs.GSamplerConfig(population=16, generations=5, seed=2)
    ws = [tiny_cnn(), resnet18()]
    fe.reset_launches()
    a = gs.gsampler_search_grid(ws, accel.PAPER_ACCEL, [32, 32],
                                [2 * MB, 8 * MB], nmax=32, cfg=cfg,
                                device=dev)
    assert fe.STATS.launches == 18 + 5 * (1 + cfg.repair_tries) + 1
    b = gs.gsampler_search_grid(ws, accel.PAPER_ACCEL, [32, 32],
                                [2 * MB, 8 * MB], nmax=32, cfg=cfg,
                                device=dev)
    for k in ("strategies", "latency", "peak_mem", "valid", "history"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    assert a.valid[:, 0].all()


# -- attention kernels: f32 at the JAX sweep's 2e-5 (tests/test_kernels.py);
# bf16 flash_decode at one bf16 rounding of the output (2^-7 relative at
# most), since both sides compute in f32 from the same bf16 inputs; bf16
# flash_attention at fa.bf16_limit, which adds the rounding of P to bf16
# that its tensor-core kernel makes before P V --
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}


def _qkv(dev, dtype, B, S, T, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=dtype,
                                     device=dev)
    return mk(B, S, Hq, hd), mk(B, T, Hkv, hd), mk(B, T, Hkv, hd)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _fa_held(q, k, v, causal=True, window=-1):
    """flash_attention on the card against its plain twin: 2e-5 + 2e-5
    |plain| in f32, fa.bf16_limit in bf16; one launch, on q's path."""
    before = (fa.STATS.launches, fa.STATS.tensor_core, fa.STATS.cuda_core)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    tc = q.dtype == torch.bfloat16
    assert (fa.STATS.launches, fa.STATS.tensor_core, fa.STATS.cuda_core) \
        == (before[0] + 1, before[1] + tc, before[2] + (not tc))
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape and got.dtype == want.dtype
    if not tc:
        _close(got, want, q.dtype)
        return
    diff = (got.float() - want.float()).abs()
    lim = fa.bf16_limit(q, k, v, causal=causal, window=window, want=want)
    assert torch.isfinite(got).all()
    assert float((diff / lim).max()) <= 1, float((diff / lim).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, -1), (False, -1),
                                           (True, 96)])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd", [
    (1, 128, 128, 2, 2, 64), (2, 256, 256, 4, 2, 64),
    (1, 256, 256, 8, 1, 128), (1, 200, 200, 4, 2, 128),
    (2, 77, 150, 4, 4, 64)])
def test_flash_attention_kernel_matches_plain(dev, dtype, causal, window,
                                              B, S, T, Hq, Hkv, hd):
    _fa_held(*_qkv(dev, dtype, B, S, T, Hq, Hkv, hd), causal, window)


@pytest.mark.parametrize("causal,window", [(True, -1), (False, -1)])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd", [
    (1, 64, 64, 1, 1, 64), (1, 64, 64, 1, 1, 128),       # one tile
    (1, 128, 128, 1, 1, 64), (1, 128, 128, 1, 1, 128),
    (2, 384, 384, 8, 1, 64), (2, 384, 384, 8, 1, 128),   # GQA 8:1
    (1, 300, 300, 8, 2, 128),                            # GQA 4:1
    (4, 1151, 1151, 32, 8, 128),                         # qwen3_8b ragged
    (2, 4096, 4096, 32, 8, 128)])                        # scoring shape
def test_flash_attention_tensor_core_shapes(dev, causal, window, B, S, T, Hq,
                                            Hkv, hd):
    _fa_held(*_qkv(dev, torch.bfloat16, B, S, T, Hq, Hkv, hd), causal,
             window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_strided_inputs(dev, dtype):
    qkv = torch.randn(2, 130, 3, 4, 64, device=dev,
                      generator=torch.Generator(dev).manual_seed(0))
    q, k, v = qkv.to(dtype).unbind(2)            # non-contiguous views
    fa.check_tma("test", q, k, v)                # aligned for TMA
    _fa_held(q, k, v)


def test_flash_attention_raises_on_a_misaligned_bf16_view(dev):
    q, k, v = _qkv(dev, torch.bfloat16, 1, 128, 128, 2, 2, 64)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=dev)
    qm = flat[1:].view(q.shape)                  # base 2 bytes off
    qm.copy_(q)
    before = (fa.STATS.launches, fa.STATS.tensor_core)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(qm, k, v)
    wide = torch.zeros(1, 128, 2, 68, dtype=q.dtype, device=dev)
    wide[..., :64] = q                           # row stride 136 bytes
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.flash_attention(wide[..., :64], k, v)
    assert (fa.STATS.launches, fa.STATS.tensor_core) == before
    # the f32 path reads through plain loads and takes such views
    q32 = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
    q32.copy_(q)                                 # base 4 bytes off
    _fa_held(q32, k.float(), v.float())
    w32 = torch.zeros(1, 128, 2, 66, device=dev)
    w32[..., :64] = q                            # row stride 264 bytes
    _fa_held(w32[..., :64], k.float(), v.float())


def test_flash_attention_counts_each_path(dev):
    fa.reset_launches()
    for dtype, n in ((torch.bfloat16, 3), (torch.float32, 2)):
        q, k, v = _qkv(dev, dtype, 1, 100, 100, 2, 1, 64)
        for _ in range(n):
            fa.flash_attention(q, k, v)
    assert (fa.STATS.launches, fa.STATS.tensor_core, fa.STATS.cuda_core) \
        == (5, 3, 2)
    info = fa.tc_info(128)
    assert info["threads"] == 384 and info["stages"] >= 2
    assert 128 * info["producer_regs"] + 256 * info["consumer_regs"] \
        <= 65536


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Hq,Hkv,hd,kv_len,bk", [
    (1, 1024, 4, 4, 64, 800, 256), (2, 2048, 8, 2, 64, 2048, 256),
    (1, 1024, 8, 1, 128, 513, 256), (1, 72, 4, 2, 64, 72, 512),
    (1, 72, 4, 2, 64, 50, 32), (1, 72, 4, 2, 64, 7, 16),
    (4, 1160, 32, 8, 128, 1025, 512)])
def test_flash_decode_kernel_matches_plain(dev, dtype, B, T, Hq, Hkv, hd,
                                           kv_len, bk):
    q, k, v = _qkv(dev, dtype, B, 1, T, Hq, Hkv, hd)
    before = fd.STATS.launches
    got = fd.flash_decode(q, k, v, kv_len, bk=bk)
    assert fd.STATS.launches == before + 1
    _close(got, fd.flash_decode_plain(q, k, v, kv_len, bk=bk), dtype)


def test_flash_decode_masks_a_poisoned_tail(dev):
    q, k, v = _qkv(dev, torch.float32, 2, 1, 1160, 32, 8, 128)
    want = fd.flash_decode_plain(q, k, v, 513, bk=256)
    k[:, 513:], v[:, 513:] = 1e6, -1e6
    got = fd.flash_decode(q, k, v, 513, bk=256)
    _close(got, want, torch.float32)
    assert torch.isfinite(got).all()


def _fd_held(q, k, v, kv_len, bk=None):
    """flash_decode on the card against its twin over the kernel's own
    splits: one launch a call, two calls bit-identical."""
    used = fd.plan(q, k, kv_len, bk)
    before = fd.STATS.launches
    got = fd.flash_decode(q, k, v, kv_len, bk=bk)
    again = fd.flash_decode(q, k, v, kv_len, bk=bk)
    assert fd.STATS.launches == before + 2
    assert torch.equal(got, again), (kv_len, bk)
    _close(got, fd.flash_decode_plain(q, k, v, kv_len, bk=used[0]), q.dtype)
    return used


def test_flash_decode_card_plan_at_every_served_kv_len(dev):
    """The card's plan (bk None) at every kv_len of a 128-token serve of
    qwen3_8b's heads: at least two blocks per SM, bk a multiple of 64."""
    q, k, v = _qkv(dev, torch.float32, 4, 1, 1160, 32, 8, 128)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kv_len in range(1025, 1152):
        bk, ns = _fd_held(q, k, v, kv_len)
        assert bk % 64 == 0 and ns * 8 * 4 >= 2 * sms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len,bk", [(1, None), (64, None), (1160, None),
                                       (700, 128), (1064, 100), (1160, 512),
                                       (90, 32)])
def test_flash_decode_plan_edges(dev, dtype, kv_len, bk):
    """kv_len 1, one split (ns 1), kv_len = T, a bk that does not divide T,
    the reference's 512, small splits; f32 and bf16."""
    q, k, v = _qkv(dev, dtype, 4, 1, 1160, 32, 8, 128)
    _, ns = _fd_held(q, k, v, kv_len, bk)
    if kv_len == 64:
        assert ns == 1


def test_flash_decode_poisoned_tail_under_the_card_plan(dev):
    q, k, v = _qkv(dev, torch.float32, 4, 1, 1160, 32, 8, 128)
    bk = fd.plan(q, k, 513)[0]
    want = fd.flash_decode_plain(q, k, v, 513, bk=bk)
    k[:, 513:], v[:, 513:] = 1e6, -1e6
    got = fd.flash_decode(q, k, v, 513)
    assert torch.isfinite(got).all()
    _close(got, want, torch.float32)


def test_flash_decode_raises_on_rows_it_cannot_copy(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 1, 64, 4, 2, 64)
    flat = torch.zeros(k.numel() + 1, device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        fd.flash_decode(q, flat[1:].view(k.shape), v, 8)
    long_k = torch.zeros(1, 600, 2, 64, device=dev)
    with pytest.raises(ValueError, match="splits"):
        fd.flash_decode(q, long_k, long_k, 600, bk=1)   # 600 splits


def test_kernels_raise_on_what_they_do_not_take(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 8, 8, 2, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        fd.flash_decode(q[:, :1], k, v, 8)
    q, k, v = _qkv(dev, torch.float32, 1, 1, 8, 16, 1, 64)
    with pytest.raises(ValueError, match="at most"):
        fd.flash_decode(q, k, v, 8)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())


def test_lm_kernel_path_matches_dense_path_on_card(dev):
    """A reduced qwen3 with the kernels' head dim: forward through
    flash_attention and decode through flash_decode agree with the dense
    path (f32; 2e-4 relative to the logits' scale, the reference's own
    model tolerance)."""
    cfg = dataclasses.replace(get_config("qwen3_8b", reduced=True),
                              head_dim=64)
    model = lm.init(cfg, seed=0, dtype=torch.float32, device=dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 130)), device=dev)
    fa.reset_launches()
    got = lm.forward(model, {"tokens": toks}, impl="kernel")
    assert fa.STATS.launches == cfg.n_layers
    want = lm.forward(model, {"tokens": toks}, impl="dense")
    tol = 2e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    fd.reset_launches()
    outs = {}
    for impl in ("kernel", "dense"):
        lg, st = lm.prefill(model, {"tokens": toks[:, :120]}, 140, impl=impl,
                            cache_dtype=torch.float32)
        seq = [lg]
        for t in range(120, 130):
            lg, st = lm.decode_step(model, st, {"tokens": toks[:, t:t + 1]},
                                    impl=impl)
            seq.append(lg)
        outs[impl] = torch.cat(seq, 1)
    assert fd.STATS.launches == 10 * cfg.n_layers
    torch.testing.assert_close(outs["kernel"], outs["dense"], rtol=0,
                               atol=tol)
    torch.testing.assert_close(outs["kernel"], got[:, 119:], rtol=0,
                               atol=tol)


# -- wkv6: f32 at the JAX sweep's 5e-5 (tests/test_kernels.py:67-70),
# relative and absolute.  The kernel updates the state with the plain
# twin's roundings, so only the order of the sum over i differs --
WKV_TOL = dict(rtol=5e-5, atol=5e-5)
DECAYS = {"mild": (0.75, 0.9995), "strong": (0.05, 0.3)}


def _wkv(dev, B, T, H, n, decay="mild", dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=torch.float32,
                                     device=dev)
    r, k, v = (mk(B, T, H, n).to(dtype) for _ in range(3))
    w = torch.as_tensor(rng.uniform(*DECAYS[decay], size=(B, T, H, n)),
                        dtype=torch.float32, device=dev)
    return r, k, v, w, mk(H, n), mk(B, H, n, n)


@pytest.mark.parametrize("B,T,H,n,chunk,decay,dtype", [
    (1, 64, 2, 32, 32, "mild", torch.float32),
    (2, 130, 3, 64, 64, "mild", torch.float32),
    (1, 256, 1, 16, 64, "mild", torch.float32),
    (1, 256, 2, 64, 64, "strong", torch.float32),
    (2, 300, 2, 16, 64, "strong", torch.float32),
    (1, 77, 2, 64, 17, "mild", torch.float32),
    (2, 130, 3, 64, rk.MAX_CHUNK, "mild", torch.float32),
    (2, 130, 3, 64, 64, "mild", torch.bfloat16)])
def test_wkv6_kernel_matches_plain(dev, B, T, H, n, chunk, decay, dtype):
    ins = _wkv(dev, B, T, H, n, decay, dtype)
    before = rk.STATS.launches
    y, s = rk.wkv6(*ins, chunk=chunk)
    assert rk.STATS.launches == before + 1
    want_y, want_s = rk.wkv6_plain(*ins)
    torch.testing.assert_close(y, want_y, **WKV_TOL)
    assert torch.equal(s, want_s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", ["mild", "strong"])
@pytest.mark.parametrize("T,chunk", [(1, None), (2, None), (33, 16),
                                     (65, 32), (7, 3), (200, None)])
def test_wkv6_decode_step_and_double_buffer_edges(dev, dtype, decay, T,
                                                  chunk):
    """T 1 (the decode step), T 2 and T 2 x chunk + 1 (the third tile
    refills the first buffer): sT bit-equal to the twin, y within the
    sweep's limit."""
    ins = _wkv(dev, 4, T, 5, 64, decay, dtype)
    y, s = rk.wkv6(*ins, chunk=chunk)
    want_y, want_s = rk.wkv6_plain(*ins)
    assert torch.equal(s, want_s)
    torch.testing.assert_close(y, want_y, **WKV_TOL)


def test_wkv6_reads_strided_inputs(dev):
    r, k, v, w, u, s0 = _wkv(dev, 2, 130, 3, 64)
    rkvw = torch.stack([r, k, v, w], 3)           # [B,T,H,4,n]
    sv = torch.stack([s0, s0], 2)[:, :, 1]        # non-contiguous s0
    uv = torch.stack([u, u], 1)[:, 0]             # non-contiguous u
    got = rk.wkv6(*rkvw.unbind(3), uv, sv)
    want = rk.wkv6_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(got[0], want[0], **WKV_TOL)
    assert torch.equal(got[1], want[1])


def test_wkv6_raises_on_what_it_does_not_take(dev):
    r, k, v, w, u, s0 = _wkv(dev, 1, 8, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        rk.wkv6(r[..., :24], k[..., :24], v[..., :24], w[..., :24],
                u[..., :24], s0[..., :24, :24])
    with pytest.raises(TypeError):
        rk.wkv6(r.half(), k.half(), v.half(), w, u, s0)
    with pytest.raises(TypeError):
        rk.wkv6(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="on"):
        rk.wkv6(r, k, v.cpu(), w, u, s0)
    with pytest.raises(ValueError, match="chunk"):
        rk.wkv6(r, k, v, w, u, s0, chunk=rk.MAX_CHUNK + 1)
    flat = torch.zeros(r.numel() + 1, device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        rk.wkv6(flat[1:].view(r.shape), k, v, w, u, s0)


def test_rwkv_kernel_path_matches_dense_path_on_card(dev):
    """The reduced rwkv6_3b: forward through wkv6, and prefill then decode
    steps through it, agree with the dense path (chunked, then the
    sequential step) and with the forward (f32; 2e-4 relative to the
    logits' scale, the reference's own model tolerance)."""
    cfg = get_config("rwkv6_3b", reduced=True)
    model = rwkv_lm.init(cfg, seed=0, dtype=torch.float32, device=dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 130)), device=dev)
    rk.reset_launches()
    got = rwkv_lm.forward(model, {"tokens": toks}, impl="kernel")
    assert rk.STATS.launches == cfg.n_layers
    want = rwkv_lm.forward(model, {"tokens": toks}, impl="dense")
    tol = 2e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    rk.reset_launches()
    outs = {}
    for impl in ("kernel", "dense"):
        lg, st = rwkv_lm.prefill(model, {"tokens": toks[:, :120]}, 130,
                                 impl=impl, cache_dtype=torch.float32)
        seq = [lg]
        for t in range(120, 130):
            lg, st = rwkv_lm.decode_step(model, st,
                                         {"tokens": toks[:, t:t + 1]},
                                         impl=impl)
            seq.append(lg)
        outs[impl] = torch.cat(seq, 1)
    assert rk.STATS.launches == 11 * cfg.n_layers   # prefill + 10 steps
    torch.testing.assert_close(outs["kernel"], outs["dense"], rtol=0,
                               atol=tol)
    torch.testing.assert_close(outs["kernel"], got[:, 119:], rtol=0,
                               atol=tol)


def test_rwkv6_3b_width_decode_step_on_card(dev):
    """rwkv6_3b at full width (2 of its 32 layers): from one prefilled
    state, a decode step through wkv6 (one launch a layer) equals the dense
    path's sequential step within 2e-4 of the logits' scale, and leaves a
    bit-equal recurrent state in the first layer."""
    cfg = dataclasses.replace(get_config("rwkv6_3b"), n_layers=2)
    model = rwkv_lm.init(cfg, seed=0, dtype=torch.float32, device=dev)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 9)), device=dev)
    _, st = rwkv_lm.prefill(model, {"tokens": toks[:, :8]}, 16,
                            cache_dtype=torch.float32)
    out = {}
    for impl in ("kernel", "dense"):
        mine = {key: a.clone() for key, a in st.items()}
        rk.reset_launches()
        lg, mine = rwkv_lm.decode_step(model, mine, {"tokens": toks[:, 8:]},
                                       impl=impl)
        out[impl] = (lg, mine["s"], rk.STATS.launches)
    assert out["kernel"][2] == cfg.n_layers and out["dense"][2] == 0
    # layer 0 sees the same inputs on both paths; later layers see inputs
    # that differ by the order of y's sum
    assert torch.equal(out["kernel"][1][0], out["dense"][1][0])
    torch.testing.assert_close(out["kernel"][1], out["dense"][1],
                               rtol=2e-4, atol=2e-4)
    tol = 2e-4 * float(out["dense"][0].abs().max())
    torch.testing.assert_close(out["kernel"][0], out["dense"][0], rtol=0,
                               atol=tol)


def _small_corpus(dev, seed=0):
    """A corpus of 2 nets x 2 parts x 2 budgets on ``dev`` and its grid."""
    from repro_torch.core import dataset
    nets, parts = [tiny_cnn(), resnet18()], [accel.ACCEL_ZOO["edge"],
                                            accel.ACCEL_ZOO["datacenter"]]
    ga = gs.GSamplerConfig(population=16, generations=6, seed=seed)
    return dataset.generate_teacher_corpus(
        nets, parts, batch=32, budgets_mb=[2.0, 16.0], max_steps=32,
        top_k=4, ga_cfg=ga, seed=seed, augment_jitter=1, device=dev), ga


def test_corpus_on_card_launches_the_grid_ga_and_rescores(dev):
    """The corpus pipeline launches only the grid GA's fusion_eval calls
    (the decoration is a prefix scan), is deterministic per seed, and the
    decoration's final costs equal the kernel's re-score."""
    from repro_torch.core import dataset
    fe.reset_launches()
    a, ga = _small_corpus(dev)
    torch.cuda.synchronize()
    assert fe.STATS.launches == 18 + ga.generations * (1 + ga.repair_tries) + 1
    b, _ = _small_corpus(dev)
    for k in ("rtg", "states", "actions", "mask", "hw"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    works = [w for w in (tiny_cnn(), resnet18()) for _ in range(4)]
    hws = [accel.ACCEL_ZOO[p] for _ in range(2)
           for p in ("edge", "edge", "datacenter", "datacenter")]
    budgets = np.array([2.0, 16.0] * 4, np.float32) * MB
    batches = np.full(8, 32.0, np.float32)
    wl = cm.stack_workloads([cm.pack_workload(w, h, 32, device=dev)
                             for w, h in zip(works, hws)])
    rng = np.random.default_rng(1)
    cand = np.stack([np.stack([cm.random_strategy(rng, w.n, 32, 32,
                                                  p_sync=0.1 * k)
                               for k in range(6)]) for w in works])
    fin = dataset._decorate_grid(wl, cand, batches, budgets, hws)[4]
    re = cm.evaluate_grid(wl, cand, batches, budgets, hws)
    for k in ("latency", "peak_mem", "traffic"):
        np.testing.assert_allclose(getattr(fin, k).cpu().numpy(),
                                   getattr(re, k).cpu().numpy(), rtol=1e-5)
    assert torch.equal(fin.valid, re.valid)
    assert torch.equal(fin.n_groups, re.n_groups)


def test_training_on_card_is_bit_exact(dev, tmp_path):
    """Two runs of one seed, and a crash plus a resume, end on the same
    parameters bit for bit (the embedding backward is deterministic)."""
    from repro_torch.core import model as dtm, train
    ds, _ = _small_corpus(dev)
    cfg = dtm.DTConfig(max_steps=32, hw_dim=accel.HW_FEATURE_DIM)
    tc = train.TrainConfig(steps=12, batch_size=32, log_every=4,
                           ckpt_every=6, seed=3)
    run = lambda **kw: train.train_model(
        dtm.dt_loss, dtm.dt_init(cfg, seed=1, device=dev), ds, tc,
        device=dev, **kw)
    a, log = run()
    b, _ = run()
    run(ckpt_dir=tmp_path, crash_at=6)
    c, rlog = run(ckpt_dir=tmp_path)
    assert rlog["start_step"] == 6
    assert log["losses"][-1][1] < log["losses"][0][1]
    ta = dtm.param_tree(a)
    for other in (b, c):
        to = dtm.param_tree(other)
        assert all(torch.equal(ta[k], to[k]) for k in ta)


def test_host_search_on_card_equals_cpu(dev):
    """The host G-Sampler draws the same numpy stream on either device, and
    the kernel is bit-equal to the twin, so the card's search is the
    CPU's."""
    from repro_torch.core import env
    cfg = gs.GSamplerConfig(population=10, generations=4, seed=2)
    got = gs.gsampler_search(env.FusionEnv(resnet18(), accel.PAPER_ACCEL, 32,
                                           4 * MB, nmax=32, device=dev), cfg)
    want = gs.gsampler_search(env.FusionEnv(resnet18(), accel.PAPER_ACCEL,
                                            32, 4 * MB, nmax=32,
                                            device="cpu"), cfg)
    np.testing.assert_array_equal(got.strategy, want.strategy)
    assert len(got.elites) == len(want.elites)
    for x, y in zip(got.elites, want.elites):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [1024, 4096, 16384])
def test_time_embedding_backward_is_deterministic_on_card(dev, n):
    """The DT's time-embedding lookup (a one-hot product) gives the same
    gradient bit for bit in every run, past the 3072 indices where
    ``F.embedding``'s CUDA backward starts to sum in a varying order."""
    from repro_torch.core import model as dtm
    model = dtm.dt_init(dtm.DTConfig(max_steps=64), seed=0, device=dev)
    gen = torch.Generator(device=dev)
    idx = torch.randint(0, 64, (n,), device=dev, generator=gen.manual_seed(1))
    g = torch.randn(n, model.cfg.d_model, device=dev,
                    generator=gen.manual_seed(2))
    grads = []
    for _ in range(3):
        model.zero_grad()
        (model.time_emb(idx) * g).sum().backward()
        grads.append(model.time.emb.grad.clone())
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    assert torch.equal(model.time_emb(idx), model.time.emb.detach()[idx])


# --- slice 8: the serving stack, polish and the portfolio on the card -------

def _serving_setup(dev, n=16, seed=0):
    """The paper-width hw-conditioned DT (seeded random weights) and ``n``
    seeded requests over the CNN zoo, every part, budgets and batches."""
    from repro_torch.core import model as dtm
    from repro_torch.serving import MapRequest
    from repro_torch.workloads import CNN_ZOO
    model = dtm.dt_init(dtm.DTConfig(hw_dim=accel.HW_FEATURE_DIM), seed=0,
                        device=dev)
    rng = np.random.default_rng(seed)
    nets = [CNN_ZOO[k]() for k in sorted(CNN_ZOO)]
    parts = sorted(accel.ACCEL_ZOO)
    reqs = [MapRequest(nets[rng.integers(len(nets))],
                       int(rng.choice([16, 64])),
                       float(rng.choice([1, 8, 12, 24, 64])) * MB,
                       accel.ACCEL_ZOO[parts[rng.integers(len(parts))]])
            for _ in range(n)]
    return model, reqs


def _same(a, b):
    assert np.array_equal(a.strategy, b.strategy)
    assert (a.latency, a.peak_mem, a.speedup, a.valid) == \
        (b.latency, b.peak_mem, b.speedup, b.valid)


def test_engine_on_card_bit_identical_alone_tick_permuted(dev):
    """A request served alone, in a tick of 16 and in three permuted
    streams through the scheduler: all five fields bit-identical."""
    from repro_torch.serving import (AsyncMapperScheduler, MapperEngine,
                                     ServingConfig)
    model, reqs = _serving_setup(dev)
    alone = [MapperEngine(model, device=dev).serve_one(r) for r in reqs]
    tick = MapperEngine(model, device=dev).serve(reqs)
    for a, b in zip(alone, tick):
        _same(a, b)
    rng = np.random.default_rng(5)
    for wave in (2, 4, 8):
        order = rng.permutation(len(reqs))
        sched = AsyncMapperScheduler(
            MapperEngine(model, device=dev),
            config=ServingConfig(flush_ms=0.0, max_wave=wave))
        futs = {}
        for t, i in enumerate(order):
            futs[i] = sched.submit(reqs[i], now=t * 1e-3)
            sched.pump(now=t * 1e-3)
        sched.drain(now=1.0)
        for i, a in enumerate(alone):
            _same(futs[i].result(), a)


def test_episode_rows_do_not_depend_on_width(dev):
    """The batched episode over the 120 smoke-grid rows, over chunks of 16
    and row by row (every 7th): each row's outputs bit-identical."""
    from repro_torch.core import infer, model as dtm
    model = dtm.dt_init(dtm.DTConfig(hw_dim=accel.HW_FEATURE_DIM), seed=0,
                        device=dev)
    parts = sorted(accel.ACCEL_ZOO)
    conds, works, batches, budgets = paper_grid(parts)
    hws = [accel.ACCEL_ZOO[p] for _, p, _ in conds]
    rows = [cm.pack_workload(w, h, 64, device=dev)
            for w, h in zip(works, hws)]
    keys = ("strategy", "latency", "peak_mem", "speedup", "valid")

    def run(idx):
        out = infer.dnnfuser_infer_batch(
            model, cm.stack_workloads([rows[i] for i in idx]), batches[idx],
            budgets[idx], [hws[i] for i in idx], device=dev)
        return {k: out[k].cpu() for k in keys}

    full = run(np.arange(120))
    for start in range(0, 120, 16):
        idx = np.arange(start, min(start + 16, 120))
        part = run(idx)
        for k in keys:
            assert torch.equal(part[k], full[k][idx]), (k, start)
    for i in range(0, 120, 7):
        one = run(np.array([i]))
        for k in keys:
            assert torch.equal(one[k][0], full[k][i]), (k, i)


def test_polish_on_card_deterministic_and_lane_independent(dev):
    from repro_torch.core.polish import polish_grid
    parts = sorted(accel.ACCEL_ZOO)
    conds, works, batches, budgets = paper_grid(parts, (2, 8, 16, 32))
    idx = np.arange(0, 120, 5)
    hws = [accel.ACCEL_ZOO[conds[i][1]] for i in idx]
    wls = cm.stack_workloads([cm.pack_workload(works[i], h, 64, device=dev)
                              for i, h in zip(idx, hws)])
    rng = np.random.default_rng(0)
    props = np.stack([cm.random_strategy(rng, works[i].n, 64, 64, 0.3)
                      for i in idx])
    a = polish_grid(wls, props, batches[idx], budgets[idx], hws, device=dev)
    b = polish_grid(wls, props, batches[idx], budgets[idx], hws, device=dev)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert a["improved"].any()
    sub = [3, 11]
    one = polish_grid({k: v[sub] for k, v in wls.items()}, props[sub],
                      batches[idx][sub], budgets[idx][sub],
                      [hws[i] for i in sub], device=dev)
    for k in a:
        assert np.array_equal(one[k], a[k][sub]), k


def test_de_on_card_lanes_independent(dev):
    """A lane's DE result does not depend on how many lanes run or which;
    and the card's run equals the CPU's (same host draws, kernel bit-equal
    to its twin)."""
    from repro_torch.core.portfolio import PortfolioConfig, de_search_grid
    cfg = PortfolioConfig(population=16, generations=12)
    works = [resnet18(), tiny_cnn(), resnet18(), tiny_cnn()]
    hws = [accel.ACCEL_ZOO[p] for p in ("edge", "nano", "datacenter",
                                        "mobile")]
    b = np.array([64, 16, 32, 64], np.float32)
    m = np.array([2, 0.5, 8, 4], np.float32) * MB
    init = np.full((4, 32), cm.SYNC, np.int32)
    for c, w in enumerate(works):
        init[c, : w.n + 1] = 8
    salts = np.zeros(4, np.uint32)
    full = de_search_grid(works, hws, b, m, nmax=32, cfg=cfg,
                          init_strategies=init, salts=salts, device=dev)
    for sub in ([0], [0, 2], [3, 0]):
        part = de_search_grid([works[i] for i in sub],
                              [hws[i] for i in sub], b[sub], m[sub],
                              nmax=32, cfg=cfg, init_strategies=init[sub],
                              salts=salts[sub], device=dev)
        for j, i in enumerate(sub):
            assert np.array_equal(part.strategies[j], full.strategies[i])
            assert part.latency[j] == full.latency[i]
            assert np.array_equal(part.history[:, j], full.history[:, i])
    cpu = de_search_grid(works, hws, b, m, nmax=32, cfg=cfg,
                         init_strategies=init, salts=salts, device="cpu")
    assert np.array_equal(cpu.strategies, full.strategies)


def test_escalating_engine_launches_fusion_eval(dev):
    from repro_torch.serving import MapperEngine, ServingConfig
    model, reqs = _serving_setup(dev, n=12, seed=2)
    eng = MapperEngine(model, device=dev,
                       config=ServingConfig(polish=True, escalate=True))
    fe.reset_launches()
    eng.serve(reqs)
    torch.cuda.synchronize()
    s = eng.stats()
    assert s["polish_invocations"] == len(reqs)
    assert fe.STATS.launches > 0
    assert s["cost_evaluator"] == "fusion_eval"


def test_card_engine_equals_cpu_engine(dev):
    """The same weights on the card and on the CPU: equal strategies and
    validity, floats within rtol 1e-5."""
    import copy
    from repro_torch.serving import MapperEngine
    model, reqs = _serving_setup(dev, n=24, seed=3)
    card = MapperEngine(model, device=dev).serve(reqs)
    cpu = MapperEngine(copy.deepcopy(model).to("cpu"),
                       device="cpu").serve(reqs)
    for a, b in zip(card, cpu):
        assert np.array_equal(a.strategy, b.strategy)
        assert (a.valid, a.cached) == (b.valid, b.cached)
        np.testing.assert_allclose([a.latency, a.peak_mem, a.speedup],
                                   [b.latency, b.peak_mem, b.speedup],
                                   rtol=1e-5)
