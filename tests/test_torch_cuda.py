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
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]     # the program's own spans
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


def test_search_round_front_door_builds_from_distinct_rows(dev):
    """A round of 3840 conditions over 6 nets x 5 parts packed once, as a
    sweep over fixed networks and parts draws them: the answers of the
    distinct-row front door (a list of parts, repeated packs) bit for bit
    those of a ``[C, 10]`` hw tensor and a plain per-key stack, and its
    stack and prepare spans copy at most 4 times to the card."""
    from repro_torch.runtime import obs
    from repro_torch.workloads import CNN_ZOO
    C, rng = 3840, np.random.default_rng(31)
    parts = [accel.ACCEL_ZOO[p] for p in sorted(accel.ACCEL_ZOO)]
    nets = [CNN_ZOO[n]() for n in sorted(CNN_ZOO)]
    packs = [[cm.pack_workload(w, h, 64, device=dev) for h in parts]
             for w in nets]
    net = rng.integers(0, len(nets), C)
    part = rng.integers(0, len(parts), C)
    budgets = np.exp(rng.uniform(np.log(8), np.log(64), C)) * MB
    batches = rng.choice([16, 64], C)
    works = [nets[a] for a in net]
    hws = [parts[b] for b in part]
    wls = [packs[a][b] for a, b in zip(net, part)]
    cfg = gs.GSamplerConfig(seed=5)

    def front_door():
        packed = cm.stack_workloads(wls)
        return gs.gsampler_search_grid(works, hws, batches, budgets, cfg=cfg,
                                       packed=packed, device=dev)

    got = front_door()
    plain = {k: torch.stack([w[k] for w in wls]) for k in wls[0]}
    hw_rows = torch.stack([accel.hw_array(h, dev) for h in hws])
    want = gs.gsampler_search_grid(works, hw_rows, batches, budgets, cfg=cfg,
                                   packed=plain, device=dev)
    for k in ("strategies", "latency", "peak_mem", "valid"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    torch.cuda.synchronize()
    names = ("stack_hw.distinct", "stack_workloads.distinct")
    before = [obs.counters(traced=True).get(n, 0) for n in names]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        front_door()
    after = [obs.counters(traced=True)[n] for n in names]
    assert [b - a for a, b in zip(before, after)] == [5, 30]
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    spans = [e.time_range for e in cpu if e.name in (
        "gsampler.prepare", "cost_model.stack_workloads")]
    assert len(spans) == 2, [e.name for e in cpu][:50]
    copies = [e.name for e in cpu if e.name.startswith("cudaMemcpy")
              and any(r.start <= e.time_range.start <= r.end
                      for r in spans)]
    assert 1 <= len(copies) <= 4, copies


# -- attention kernels: f32 at the JAX sweep's 2e-5 (tests/test_kernels.py);
# bf16 flash_decode at one bf16 rounding of the output (2^-7 relative at
# most), since both sides compute in f32 from the same bf16 inputs; bf16
# flash_attention at fa.bf16_limit, which adds the rounding of P to bf16
# that its tensor-core kernel makes before P V --
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}


def _qkv(dev, dtype, B, S, T, Hq, Hkv, hd, seed=0, hv=None):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(rng.normal(size=sh), dtype=dtype,
                                     device=dev)
    return mk(B, S, Hq, hd), mk(B, T, Hkv, hd), mk(B, T, Hkv, hv or hd)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _paths():
    return (fa.STATS.launches, fa.STATS.tensor_core,
            fa.STATS.tensor_core_tf32x3)


def _fa_held(q, k, v, causal=True, window=-1):
    """flash_attention on the card against its plain twin: 2e-5 + 2e-5
    |plain| in f32 (the 3xTF32 path), fa.bf16_limit in bf16; one launch,
    on q's path, and on the (192, 128) instance where v is 128 wide and
    q 192."""
    before = _paths()
    latent = fa.STATS.tensor_core_192_128
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    tc = q.dtype == torch.bfloat16
    assert _paths() == (before[0] + 1, before[1] + tc, before[2] + (not tc))
    assert fa.STATS.tensor_core_192_128 == latent + (
        (q.shape[-1], v.shape[-1]) == (192, 128))
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
    # the f32 path reads through TMA too, and raises on such views
    q32 = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
    q32.copy_(q)                                 # base 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(q32, k.float(), v.float())
    w32 = torch.zeros(1, 128, 2, 66, device=dev)
    w32[..., :64] = q                            # row stride 264 bytes
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.flash_attention(w32[..., :64], k.float(), v.float())
    assert _paths()[0] == before[0]


def test_flash_attention_f32_takes_aligned_views_and_raises_on_others(dev):
    """The 3xTF32 path reads q, k and v by TMA: views whose bases and
    strides are 16-byte multiples are read in place, others raise before
    any launch."""
    q, k, v = _qkv(dev, torch.float32, 1, 130, 130, 2, 2, 64)
    flat = torch.zeros(q.numel() + 4, device=dev)
    q16 = flat[4:].view(q.shape)                 # base 16 bytes off
    q16.copy_(q)
    _fa_held(q16, k, v)
    wide = torch.zeros(1, 130, 2, 68, device=dev)
    wide[..., :64] = k                           # row stride 544 bytes
    _fa_held(q, wide[..., :64], v)
    before = _paths()
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(flat[1:1 + q.numel()].view(q.shape), k, v)
    odd = torch.zeros(1, 130, 2, 65, device=dev)
    odd[..., :64] = v                            # row stride 260 bytes
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.flash_attention(q, k, odd[..., :64])
    assert _paths() == before


def test_flash_attention_counts_each_path(dev):
    fa.reset_launches()
    for dtype, n in ((torch.bfloat16, 3), (torch.float32, 2)):
        q, k, v = _qkv(dev, dtype, 1, 100, 100, 2, 1, 64)
        for _ in range(n):
            fa.flash_attention(q, k, v)
    assert _paths() == (5, 3, 2)
    info = fa.tc_info(128)
    assert info["threads"] == 384 and info["stages"] >= 2
    assert 128 * info["producer_regs"] + 256 * info["consumer_regs"] \
        <= 65536
    smem = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    for hd, _ in fa.HEAD_DIMS[torch.float32]:
        info = fa.tf32_info(hd)
        assert info["threads"] == 256 and info["stages"] >= 2
        assert info["keys"] % 8 == 0 and info["smem_bytes"] <= smem


def test_flash_attention_tc_instances_and_their_shapes(dev):
    """The built tensor-core kernel takes HEAD_DIMS' bf16 pairs; <64,64>
    and <128,128> keep three 128-key stages (113 and 225 KB), <192,128>
    takes two (209 KB), each within a block's shared memory."""
    smem = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    want = {(64, 64): (3, 115792), (128, 128): (3, 230480),
            (192, 128): (2, 214088)}
    assert tuple(want) == fa.HEAD_DIMS[torch.bfloat16]
    for (hd, hv), (stages, size) in want.items():
        info = fa.tc_info(hd, hv)
        assert (info["stages"], info["smem_bytes"]) == (stages, size)
        assert info["threads"] == 384 and size <= smem
        assert 128 * info["producer_regs"] + 256 * info["consumer_regs"] \
            <= 65536
    assert fa.tc_info(128) == fa.tc_info(128, 128)
    with pytest.raises(ValueError, match="head dims"):
        fa.tc_info(96, 64)


@pytest.mark.parametrize("B,S,Hq,Hkv", [
    (1, 64, 1, 1), (1, 200, 4, 4),                       # one tile, ragged
    (4, 320, 16, 16), (4, 1168, 16, 16),                 # the code cell's
    (1, 6592, 16, 16)])                                  # lengths
def test_flash_attention_latent_pair_matches_plain(dev, B, S, Hq, Hkv):
    """bf16 q/k 192 and v 128 (latent attention's prompt) on the
    <192,128> instance, causal, at fa.bf16_limit."""
    _fa_held(*_qkv(dev, torch.bfloat16, B, S, S, Hq, Hkv, 192, hv=128))


def test_flash_attention_latent_pair_reads_v_as_half_a_row(dev):
    """V as MLA hands it: the [..., 128:] half of the up-projection's [B,
    S, H, 256] output, read through its strides."""
    q, k, kv = _qkv(dev, torch.bfloat16, 2, 300, 300, 16, 16, 192, hv=256)
    v = kv[..., 128:]
    assert not v.is_contiguous()
    fa.check_tma("test", q, k, v)
    _fa_held(q, k, v)


def test_flash_attention_refuses_pairs_it_lacks(dev):
    """No f32 instance at (192, 128), no instance at (96, 64): both raise
    before any launch."""
    q, k, v = _qkv(dev, torch.float32, 1, 64, 64, 2, 2, 192, hv=128)
    q2, k2, v2 = _qkv(dev, torch.bfloat16, 1, 64, 64, 2, 2, 96, hv=64)
    before = _paths() + (fa.STATS.tensor_core_192_128,)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q2, k2, v2)
    assert _paths() + (fa.STATS.tensor_core_192_128,) == before


def test_moonlight_mla_layer_on_the_latent_kernel_matches_dense(
        dev, monkeypatch):
    """One bf16 latent-attention layer at Moonlight-16B-A3B's published
    widths (d 2048, 16 heads, latent 512, q/k 128 + 64, v 128), B 2, S
    1168: ``impl="kernel"`` launches flash_attention's (192, 128) instance
    once, and its output matches ``impl="dense"`` (the chunked f32 math)
    within this bound.  The two attention outputs A differ by at most
    fa.bf16_limit elementwise (each side's bf16 output rounding, and P
    rounded to bf16 before P V: the kernel's own gate).  Everything else
    in the layer is the same bf16 code on the same inputs, so through
    ``o`` the difference is at most |A_k - A_d| @ |W_o|, plus each side's
    rounding of the product to bf16 (2^-8 |y|) and 2^-8 (|A| @ |W_o|) for
    partial sums the bf16 product may round."""
    from repro_torch import configs
    from repro_torch.nn import mla as mla_mod
    cfg = configs.get_config("moonlight_16b_a3b")
    gen = torch.Generator(dev).manual_seed(0)
    att = mla_mod.MLA(cfg.d_model, n_heads=cfg.n_heads,
                      kv_lora_rank=cfg.kv_lora_rank,
                      qk_nope_head_dim=cfg.qk_nope_head_dim,
                      qk_rope_head_dim=cfg.qk_rope_head_dim,
                      v_head_dim=cfg.v_head_dim, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    B, S = 2, 1168
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    cos, sin = lm._rope_tables(cfg, {}, torch.arange(S, device=dev))
    seen = []

    def attend(q, k, v, **kw):
        out = real(q, k, v, **kw)
        seen.append((q, k, v, out))
        return out
    real = mla_mod.attend
    monkeypatch.setattr(mla_mod, "attend", attend)
    with torch.no_grad():
        before = (fa.STATS.launches, fa.STATS.tensor_core_192_128)
        y_d, _ = att(x, cos=cos, sin=sin, impl="dense")
        assert (fa.STATS.launches, fa.STATS.tensor_core_192_128) == before
        y_k, _ = att(x, cos=cos, sin=sin, impl="kernel")
        assert (fa.STATS.launches, fa.STATS.tensor_core_192_128) == (
            before[0] + 1, before[1] + 1)
    (q, k, v, a_d), (_, _, _, a_k) = seen
    assert (q.shape[-1], k.shape[-1], v.shape[-1]) == (192, 192, 128)
    lim_a = fa.bf16_limit(q, k, v, want=a_d)
    assert float(((a_k.float() - a_d.float()).abs() / lim_a).max()) <= 1
    w = att.o.w.detach().float().abs()
    u = 2.0 ** -8
    lim = (lim_a @ w + u * (a_d.float().abs() @ w + y_k.float().abs()
                            + y_d.float().abs()))
    diff = (y_k.float() - y_d.float()).abs()
    assert torch.isfinite(y_k).all()
    assert float((diff / lim).max()) <= 1, float((diff / lim).max())


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window", [
    (4, 1151, 1151, 32, 8, 128, True, -1),               # the self-check's
    (1, 4096, 4096, 32, 8, 128, True, -1),               # f32 scoring rows
    (1, 64, 64, 1, 1, 128, True, -1), (1, 64, 64, 1, 1, 64, False, -1),
    (2, 384, 384, 8, 1, 64, True, 96), (1, 300, 300, 8, 2, 128, False, -1),
    (1, 1, 200, 2, 1, 64, False, -1), (2, 130, 70, 4, 4, 128, False, -1)])
def test_flash_attention_f32_is_deterministic_at_model_shapes(
        dev, B, S, T, Hq, Hkv, hd, causal, window):
    """The 3xTF32 path at qwen3_8b's heads and at the tile edges: within
    the f32 gate, one launch a call, two calls bit-identical."""
    q, k, v = _qkv(dev, torch.float32, B, S, T, Hq, Hkv, hd)
    _fa_held(q, k, v, causal, window)
    before = _paths()
    a = fa.flash_attention(q, k, v, causal=causal, window=window)
    b = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert _paths() == (before[0] + 2, before[1], before[2] + 2)
    assert torch.equal(a, b)


def _attention_f64(q, k, v, causal):
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.double().reshape(B, S, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.double()) / hd ** 0.5
    if causal:
        ok = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~ok, float("-inf"))
    out = torch.einsum("bkgst,btkh->bskgh", torch.softmax(s, -1), v.double())
    return out.reshape(B, S, Hq * hd)


@pytest.mark.parametrize("scale", [4.0, 8.0])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal", [
    (1, 1024, 8, 2, 128, True), (1, 300, 4, 4, 64, False)])
def test_flash_attention_f32_as_exact_as_f32_at_large_scores(
        dev, B, S, Hq, Hkv, hd, causal, scale):
    """q and k scaled by 4 and 8: no f32 kernel holds the 2e-5 gate
    against the twin there, so both are held to an f64 attention, the
    kernel's error at most twice the twin's."""
    q, k, v = _qkv(dev, torch.float32, B, S, S, Hq, Hkv, hd)
    q, k = q * scale, k * scale
    exact = _attention_f64(q, k, v, causal)
    got = fa.flash_attention(q, k, v, causal=causal).double()
    twin = fa.flash_attention_plain(q, k, v, causal=causal).double()
    got_err = float((got - exact).abs().max())
    twin_err = float((twin - exact).abs().max())
    assert 0 < got_err <= 2 * twin_err, (got_err, twin_err)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd", [(64, 4, 128), (25, 5, 64),
                                       (48, 8, 128)])
@pytest.mark.parametrize("kv_len,bk", [(1, None), (1025, None),
                                       (1160, None), (700, 128),
                                       (1160, 2048)])
def test_flash_decode_groups_of_5_6_and_16(dev, dtype, Hq, Hkv, hd, kv_len,
                                          bk):
    """The decode head shapes of the MoE, hybrid and VLM configs: G 16
    (qwen3_moe_235b, the 16-head build), 5 (hymba_15b) and 6 (grok1_314b);
    one launch a call, two calls bit-identical, within the twin's limits;
    at G 16 the largest split the kernel takes (2048)."""
    q, k, v = _qkv(dev, dtype, 4, 1, 1160, Hq, Hkv, hd)
    _fd_held(q, k, v, kv_len, bk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Hq,Hkv,hd", [(524288, 25, 5, 64),
                                         (262144, 64, 4, 128)])
def test_flash_decode_card_plan_at_a_long_cache(dev, dtype, T, Hq, Hkv, hd):
    """hymba_15b's long_500k decode (524288 keys, G 5) and qwen3_moe_235b's
    at 262144 keys (G 16): the card's plan grows bk past 512 to stay within
    the kernel's split count, and the kernel holds its twin there."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(sh, generator=gen, device=dev).to(dtype)
               for sh in ((1, 1, Hq, hd), (1, T, Hkv, hd), (1, T, Hkv, hd)))
    bk, ns = _fd_held(q, k, v, T)
    assert bk > fd.BK and ns <= fd.limits(Hq // Hkv)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd", [(8, 8, 64), (32, 8, 128),
                                       (25, 5, 64), (64, 8, 128),
                                       (64, 4, 128)])
@pytest.mark.parametrize("R", [2, 4, 16])
def test_flash_decode_stats_and_shard_merge(dev, dtype, Hq, Hkv, hd, R):
    """The statistics output (G 1, 4, 5, 8, 16): the output path is the
    one-shot call's bit for bit, the log-sum-exp within the gate of the
    twin's, and the merge of R key shards (kv_len 700 of 1152: with 4 and
    16 some shards hold no visible key and launch nothing) within the
    gate of the unsharded call."""
    from repro_torch.distributed import tp
    q, k, v = _qkv(dev, dtype, 4, 1, 1152, Hq, Hkv, hd)
    one = fd.flash_decode(q, k, v, 700)
    out, lse = fd.flash_decode(q, k, v, 700, stats=True)
    assert torch.equal(out, one) and lse.dtype == torch.float32
    _close(lse, fd.flash_decode_plain(q, k, v, 700, stats=True)[1],
           torch.float32)
    Tl, outs, lses = 1152 // R, [], []
    before = fd.STATS.launches
    for r in range(R):
        seen = min(max(700 - r * Tl, 0), Tl)
        o, l = fd.flash_decode(q, k[:, r * Tl:(r + 1) * Tl],
                               v[:, r * Tl:(r + 1) * Tl], seen, stats=True)
        outs.append(o.reshape(4, Hq, hd))
        lses.append(l)
    assert fd.STATS.launches - before == -(-700 // Tl)
    got = tp.merge_partials(torch.stack(outs), torch.stack(lses))
    assert torch.isfinite(got).all()
    _close(got.reshape(one.shape), fd.flash_decode_plain(q, k, v, 700),
           dtype)


def test_flash_decode_g16_limits(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 1, 4200, 16, 1, 128)
    with pytest.raises(ValueError, match="above 2048"):
        fd.flash_decode(q, k, v, 4200, bk=4096)
    assert fd.limits(16) == (2048, 256) and fd.limits(8) == (4096, 512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window", [
    (4, 1, 1500, 8, 8, 64, False, -1),          # whisper decode cross-attn
    (4, 187, 1500, 8, 8, 64, False, -1),        # whisper prefill cross-attn
    (2, 2048, 2048, 25, 5, 64, True, 1024)])    # hymba's windowed layers
def test_flash_attention_at_the_new_families_shapes(dev, dtype, B, S, T, Hq,
                                                   Hkv, hd, causal, window):
    q, k, v = _qkv(dev, dtype, B, S, T, Hq, Hkv, hd)
    if dtype == torch.bfloat16:
        _fa_held(q, k, v, causal, window)
        return
    before = fa.STATS.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.STATS.launches == before + 2 and torch.equal(got, again)
    _close(got, fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window), dtype)


def test_moe_forward_on_card_is_bit_identical(dev):
    """A reduced qwen3_moe at the kernels' head dim, built twice from one
    seed: logits and aux bit-identical (the combine sums a token's experts
    in a fixed order, no atomics), routing equal to the CPU's."""
    from repro_torch.models import lm as tlm
    from repro_torch.nn import moe as tmoe
    cfg = dataclasses.replace(get_config("qwen3_moe_235b", reduced=True),
                              head_dim=64)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 130)), device=dev)
    outs = []
    for _ in range(2):
        model = tlm.init(cfg, seed=0, dtype=torch.float32, device=dev)
        outs.append(tlm.forward_aux(model, {"tokens": toks}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 130, 64)),
                        dtype=torch.float32)
    moe = model.blocks[0].moe
    got = tmoe.moe_route(moe.to(dev), x.to(dev), top_k=cfg.moe_top_k,
                         capacity_factor=cfg.capacity_factor)
    want = tmoe.moe_route(moe.cpu(), x, top_k=cfg.moe_top_k,
                          capacity_factor=cfg.capacity_factor)
    assert got.C == want.C
    assert torch.equal(got.idx.cpu(), want.idx)
    assert torch.equal(got.keep.cpu(), want.keep)


def test_kernels_raise_on_what_they_do_not_take(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 8, 8, 2, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        fd.flash_decode(q[:, :1], k, v, 8)
    q, k, v = _qkv(dev, torch.float32, 1, 1, 8, 17, 1, 64)
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


# --- slice 9: the Table-1 baselines and the exact optimum -------------------

@pytest.mark.parametrize("method", ["CMA", "DE", "PSO", "Random", "TBPSA",
                                    "stdGA"])
def test_baseline_on_card_equals_cpu(dev, method):
    """The optimizers draw the same numpy stream on either device, and the
    kernel is bit-equal to its twin, so a run on the card is the CPU's: same
    strategy and costs, 51 fusion_eval launches at 2000 samples."""
    from repro_torch.core import baselines, env
    from repro_torch.workloads import vgg16
    args = (vgg16(batch=128), accel.PAPER_ACCEL, 128, 40 * MB)
    fe.reset_launches()
    got = baselines.run_baseline(env.FusionEnv(*args, nmax=20, device=dev),
                                 method, budget=2000, seed=0)
    assert fe.STATS.launches == 1 + 2000 // 40 + 1     # env reset + 50 + 1
    want = baselines.run_baseline(env.FusionEnv(*args, nmax=20,
                                                device="cpu"),
                                  method, budget=2000, seed=0)
    np.testing.assert_array_equal(got.strategy, want.strategy)
    assert (got.latency, got.peak_mem, got.valid, got.n_evals) == \
        (want.latency, want.peak_mem, want.valid, want.n_evals)


def test_optimal_certification_on_card(dev):
    """optimal_mapping certifies in one launch a condition, optimal_grid in
    one for the grid, and both give the CPU's optimum and f32 costs."""
    from repro_torch.core import env, optimal
    nets = [tiny_cnn(), tiny_cnn()]
    hws = [accel.ACCEL_ZOO["edge"], accel.ACCEL_ZOO["nano"]]
    budgets = [2 * MB, 6 * MB]
    fe.reset_launches()
    grid = optimal.optimal_grid(nets, hws, [64, 64], budgets, device=dev)
    assert fe.STATS.launches == 1
    cpu = optimal.optimal_grid(nets, hws, [64, 64], budgets, device="cpu")
    for g, c, w, h, b in zip(grid, cpu, nets, hws, budgets):
        np.testing.assert_array_equal(g.strategy, c.strategy)
        assert g.latency == c.latency and g.certified == c.certified
        e = env.FusionEnv(w, h, 64, b, nmax=64, device=dev)
        fe.reset_launches()
        one = optimal.optimal_mapping(e)
        assert fe.STATS.launches == 1
        np.testing.assert_array_equal(one.strategy, g.strategy)
        assert one.latency == g.latency
        assert float(one.certified.latency) == float(g.certified.latency)


def test_s2s_episode_rows_do_not_depend_on_width(dev):
    """The S2S's batched episode on 128-lane blocks: the 120 smoke-grid rows
    at once, in chunks of 16 and one by one give each row bit-identical
    outputs."""
    from repro_torch.core import infer, seq2seq
    model = seq2seq.s2s_init(seq2seq.S2SConfig(hw_dim=accel.HW_FEATURE_DIM),
                             seed=0, device=dev)
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
    for i in range(0, 120, 11):
        one = run(np.array([i]))
        for k in keys:
            assert torch.equal(one[k][0], full[k][i]), (k, i)


# -- LM training (slice 12) --------------------------------------------------

def _grad_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, 130, 4, 64, device=dev, generator=g)
    kv = torch.randn(1, 130, 2, 64, device=dev, generator=g)
    r, k, v, w = torch.rand(4, 1, 9, 2, 64, device=dev, generator=g).unbind(0)
    u = torch.rand(2, 64, device=dev, generator=g)
    s0 = torch.zeros(1, 2, 64, 64, device=dev)
    return {"flash_attention": (fa.flash_attention, (q, kv, kv)),
            "flash_decode": (fd.flash_decode, (q[:, :1], kv, kv, 100)),
            "wkv6": (rk.wkv6, (r, k, v, w, u, s0))}


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode", "wkv6"])
def test_kernels_refuse_inputs_that_require_grad_on_card(dev, name):
    """A kernel writes a fresh tensor and has no backward: under grad mode
    an input that requires grad raises (and launches nothing); under
    ``no_grad`` the same call launches once."""
    fn, args = _grad_inputs(dev)[name]
    mod = {"flash_attention": fa, "flash_decode": fd, "wkv6": rk}[name]
    grad_args = [a.clone().requires_grad_() if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args]
    mod.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*grad_args)
    assert mod.STATS.launches == 0
    with torch.no_grad():
        fn(*grad_args)
    torch.cuda.synchronize()
    assert mod.STATS.launches == 1


@pytest.mark.parametrize("arch", ["gemma3_1b", "rwkv6_3b", "qwen3_moe_235b"])
def test_default_loss_gradients_on_card_match_cpu(dev, arch):
    """The default ``loss_fn``'s gradients on the card equal the same
    weights' and batch's on the CPU (the path the CPU tests hold to
    ``jax.grad``): each leaf within 2e-4 of its largest CPU gradient (the
    CPU tests' ``GRAD_TOL``), the loss within rtol 2e-4, all finite, none
    all zero; no kernel is launched, and ``impl="kernel"`` refuses."""
    from repro_torch.checkpoint import (lm_params_from_reference,
                                        lm_train_state_to_reference)
    from repro_torch.core.model import param_tree
    from repro_torch.launch import train as lt
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import adamw
    cfg = get_config(arch, reduced=True)
    mod = get_model(cfg)
    model = mod.init(cfg, seed=0, dtype=torch.float32, device=dev)
    host = lm_params_from_reference(lm_train_state_to_reference(
        model, adamw(1e-3).init(param_tree(model)), 0)["params"], cfg,
        device="cpu")

    def grads(m, device):
        batch = lt.make_batch_fn(cfg, seq_len=64, global_batch=4,
                                 device=device)(0)
        loss = mod.loss_fn(m, batch)
        return float(loss.detach()), torch.autograd.grad(
            loss, list(param_tree(m).values()))
    for m in (fa, fd, rk):
        m.reset_launches()
    loss, got = grads(model, dev)
    want_loss, want = grads(host, "cpu")
    assert loss == pytest.approx(want_loss, rel=2e-4)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all()) and bool(a.any())
        assert float((a.cpu() - b).abs().max()) <= 2e-4 * float(
            b.abs().max())
    assert fa.STATS.launches == fd.STATS.launches == rk.STATS.launches == 0
    with pytest.raises(RuntimeError, match="no backward"):
        mod.loss_fn(model, lt.make_batch_fn(cfg, seq_len=64, global_batch=4,
                                            device=dev)(0), impl="kernel")


def test_take_rows_backward_on_card_is_deterministic_and_linear(dev):
    """``nn.linear.take_rows`` at 65536 Zipf ids into 1000 rows of 256:
    the forward is the plain gather's bit for bit, the backward the same
    bits three times, within f32 summation error of the f64 sum, and its
    peak memory a few [n, d] buffers (not [n, n])."""
    from repro_torch.nn.linear import take_rows
    rng = np.random.default_rng(0)
    n, rows, d = 65536, 1000, 256
    table = torch.as_tensor(rng.normal(size=(rows, d)), dtype=torch.float32,
                            device=dev).requires_grad_()
    ids = torch.as_tensor(rng.zipf(1.3, size=n) % rows, device=dev)
    g = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                        device=dev)
    assert torch.equal(take_rows(table, ids), table[ids])
    got = []
    for _ in range(3):
        out = take_rows(table, ids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got.append(torch.autograd.grad(out, table, g)[0])
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base <= 8 * n * d * 4
    assert all(torch.equal(got[0], x) for x in got[1:])
    exact = torch.zeros(rows, d, dtype=torch.float64, device=dev).index_add_(
        0, ids, g.double())
    scale = torch.zeros_like(exact).index_add_(0, ids, g.double().abs())
    assert ((got[0].double() - exact).abs() <= 17 * 2.0 ** -24 * scale).all()


def test_lm_training_crash_and_resume_is_bit_exact_on_card(dev, tmp_path):
    """``launch.train`` on the card (reduced gemma3_1b, MoE and RWKV6):
    crashed at step 10 and restarted, it ends on the straight run's
    parameters, moments and loss bit for bit (the row gathers' backward is
    deterministic)."""
    from repro_torch.core.model import param_tree
    from repro_torch.launch import train as lt
    for arch in ("gemma3_1b", "qwen3_moe_235b", "rwkv6_3b"):
        kw = dict(reduced=True, steps=20, device=dev)
        a, _ = lt.train(arch, ckpt_dir=str(tmp_path / arch / "a"), **kw)
        with pytest.raises(RuntimeError, match="simulated node failure"):
            lt.train(arch, ckpt_dir=str(tmp_path / arch / "b"), crash_at=10,
                     **kw)
        b, _ = lt.train(arch, ckpt_dir=str(tmp_path / arch / "b"), **kw)
        assert b.start_step == 11 and a.losses[-1] == b.losses[-1]
        assert a.losses[-1][1] < a.losses[0][1]
        for x, y in ((param_tree(a.model), param_tree(b.model)),
                     (a.opt_state.mu, b.opt_state.mu),
                     (a.opt_state.nu, b.opt_state.nu)):
            assert all(torch.equal(x[k], y[k]) for k in x), arch
