"""The ``fusion_eval`` kernel's forms, its CostOut and its host path, on the
CPU (where the wrappers run the plain twin).

- The cost, stats and raw forms give the same CostOut bit for bit, and the
  stats form the raw form's ``gid`` and ``M_g``; the raw matrices through
  ``cost_model.finalize_groups`` (the sequential epilogue) give it too.
- The twin's CostOut against the JAX reference (``evaluate_grid`` and
  ``kernels/ref.fusion_eval_grid_ref``, both at the XLA path) on the zoo
  grid: ``valid``, ``n_groups`` (and ``gid`` under the mask) equal, floats
  within rtol 1e-5, the tolerance of ``test_torch_cost_model.py``.
- A numpy emulation of the CUDA kernel's algorithm (the chunked ballots,
  the in-place group columns, the parallel roofline pass, the in-order
  sums), one f32 rounding per operation as in the source, equals the twin
  bit for bit: the kernel's order of operations, checked without a card.
- The cached host check refuses a wrong dtype, shape, device or layout
  with ``_check``'s own message, also after the same signature was cached.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, MB, assert_costout_close, to_np
from repro.core import accel as jaccel, cost_model as jcm
from repro.core.accel import ACCEL_ZOO as JZOO
from repro.kernels import ref as jref
from repro.workloads import CNN_ZOO as JCNN
from repro_torch.core import accel as taccel, cost_model as tcm
from repro_torch.kernels import fusion_eval as fe
from repro_torch.workloads import CNN_ZOO as TCNN

torch.set_num_threads(2)

BATCH = 32
P_SYNC = (0.0, 0.15, 0.3, 0.45, 0.6, 0.75, 0.9, 1.0)


def _zoo(pop, nmax=64, budgets_mb=(8, 32), seed=0):
    """6 CNNs x 5 parts x budgets, packed for ``edge`` and served on each
    part (so the BPE rescale runs), ``pop`` strategies a condition from no
    SYNC to all SYNC.  Returns (conditions, strategies, the port's packing,
    hw rows, batches and budgets)."""
    names, parts = sorted(TCNN), sorted(taccel.ACCEL_ZOO)
    conds = [(w, p, b) for w in names for p in parts for b in budgets_mb]
    rng = np.random.default_rng(seed)
    strats = np.stack([np.stack([
        tcm.random_strategy(rng, TCNN[w]().n, nmax, BATCH,
                            p_sync=P_SYNC[j % len(P_SYNC)])
        for j in range(pop)]) for w, _, _ in conds])
    wls = tcm.stack_workloads([
        tcm.pack_workload(TCNN[w](), taccel.ACCEL_ZOO["edge"], nmax,
                          device=CPU) for w, _, _ in conds])
    hw = taccel.stack_hw([taccel.ACCEL_ZOO[p] for _, p, _ in conds],
                         len(conds), CPU)
    C = len(conds)
    batches = torch.full((C,), float(BATCH))
    budgets = torch.tensor([b * MB for _, _, b in conds], dtype=torch.float32)
    return conds, strats, wls, hw, batches, budgets


def _assert_cost_equal(got, want):
    for k in want._fields:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k


# pop 1 (the naive search, the re-score), 8, and nmax = n + 1 for the
# largest network (its last layer at position P - 1)
SHAPES = [(1, 64), (8, 64), (3, max(w().n for w in TCNN.values()) + 1)]


@pytest.mark.parametrize("pop,nmax", SHAPES)
def test_forms_agree_bit_for_bit(pop, nmax):
    _, strats, wls, hw, batches, budgets = _zoo(pop, nmax)
    s = torch.as_tensor(strats)
    args = fe.kernel_args(wls, s, batches, hw)
    (cost,) = fe.fusion_eval(fe.Form.COST, args, budgets)
    st_cost, gid, M_g = fe.fusion_eval(fe.Form.STATS, args, budgets)
    raw = fe.fusion_eval(fe.Form.RAW, args, budgets)
    _assert_cost_equal(st_cost, cost)
    _assert_cost_equal(raw[0], cost)
    assert torch.equal(gid, raw[7]) and torch.equal(M_g, raw[4])
    _assert_cost_equal(tcm.finalize_groups(*raw[1:7], budgets[:, None],
                                           hw[:, None, :]), cost)
    for g, w in zip(fe.fusion_eval_raw(*args), raw[1:]):
        assert torch.equal(g, w)
    _assert_cost_equal(fe.fusion_eval_grid(wls, s, batches, budgets, hw),
                       cost)
    out = fe.fusion_eval_grid_stats(wls, s, batches, budgets, hw)
    _assert_cost_equal(out[0], cost)
    assert torch.equal(out[1], gid) and torch.equal(out[2], M_g)
    assert cost.latency.shape == (s.shape[0], pop)


def _reference(conds, strats, nmax):
    jwls = jcm.stack_workloads([jcm.pack_workload(JCNN[w](), JZOO["edge"],
                                                  nmax) for w, _, _ in conds])
    jhw = [JZOO[p] for _, p, _ in conds]
    batches = jnp.full((len(conds),), float(BATCH), jnp.float32)
    budgets = jnp.asarray([b * MB for _, _, b in conds], jnp.float32)
    return jwls, jnp.asarray(strats), batches, budgets, jhw


@pytest.mark.parametrize("oracle", ["evaluate_grid", "fusion_eval_grid_ref"])
def test_twin_costout_matches_reference(oracle):
    conds, strats, wls, hw, batches, budgets = _zoo(8)
    got, gid, M_g = fe.fusion_eval_grid_stats(wls, torch.as_tensor(strats),
                                              batches, budgets, hw)
    ref = _reference(conds, strats, 64)
    if oracle == "evaluate_grid":
        assert_costout_close(got, jcm.evaluate_grid(*ref, evaluator="xla"))
        return
    want, wgid, wM = jref.fusion_eval_grid_ref(*ref)
    assert_costout_close(got, want)
    mask = np.broadcast_to(to_np(wls["mask"])[:, None, :], gid.shape)
    np.testing.assert_array_equal(to_np(gid)[mask], np.asarray(wgid)[mask])
    np.testing.assert_allclose(to_np(M_g), np.asarray(wM), rtol=1e-5, atol=0)


def test_finalize_groups_matches_reference():
    """The sequential epilogue against the reference's ``finalize_groups``
    (``jnp.sum``/``jnp.max``) on the same group matrices."""
    conds, strats, wls, hw, batches, budgets = _zoo(8)
    args = fe.kernel_args(wls, torch.as_tensor(strats), batches, hw)
    mats = fe.fusion_eval_raw(*args)[:6]
    got = tcm.finalize_groups(*mats, budgets[:, None], hw[:, None, :])
    jhw = jaccel.stack_hw([JZOO[p] for _, p, _ in conds], len(conds))
    jhw = jax.tree_util.tree_map(lambda x: x[:, None, None], jhw)
    want = jcm.finalize_groups(*(jnp.asarray(to_np(m)) for m in mats),
                               jnp.asarray(to_np(budgets))[:, None], jhw)
    assert_costout_close(got, want)


# -- the CUDA kernel's algorithm, emulated in numpy f32 ----------------------

_F = np.float32
STEP = 8          # kStep of the source


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


def _maxp(a, b):
    return a if (a > b or a != a) else b


def _emulate(inputs):
    """``csrc/fusion_eval.cu`` step by step, a candidate row at a time (as a
    warp takes it): CostOut and the seven group matrices."""
    strat, A, W, F, OE, UC, SKIP, n, batch, bpe, hw, budget = (
        to_np(t) for t in inputs)
    C, POP, P = strat.shape
    util_min = _F(1.0 / 4096.0)
    lat, peak_o, traf = (np.zeros((C, POP), _F) for _ in range(3))
    valid = np.zeros((C, POP), bool)
    ngroups = np.zeros((C, POP), np.int32)
    mats = np.zeros((6, C, POP, P), _F)
    gid = np.zeros((C, POP, P), np.int32)
    for c in range(C):
        h = hw[c]
        B = batch[c]
        lanes = h[0] * h[1]
        peak_macs = lanes * h[2]
        stream_buf = h[9]
        scale = h[6] / bpe[c]
        nn = min(int(n[c]), P - 1)
        tA = [A[c, i] * scale for i in range(P)]
        tW = [W[c, i] * scale for i in range(P)]
        tBF = [B * F[c, i] / peak_macs for i in range(P)]
        tCA = [tBF[i] / _clip(B * OE[c, i] / lanes, util_min, UC[c, i])
               for i in range(P)]
        for q in range(POP):
            x = np.full((5, P + 1), np.nan, _F)
            tails = np.zeros(P + 32, bool)
            s = strat[c, q]
            last, cnt, sync_top = -1, 0, False
            for base in range(0, P, 32):
                live = [1 <= base + l <= nn for l in range(32)]
                sync = [live[l] and s[base + l] < 0 for l in range(32)]
                sb = sum(1 << l for l in range(32) if sync[l])
                for l in range(32):
                    i = base + l
                    below = sb & ((1 << l) - 1)
                    lastb = base + below.bit_length() - 1 if below \
                        else last
                    prev_sync = bool((sb >> (l - 1)) & 1) if l \
                        else sync_top
                    head = i == 1 or prev_sync
                    tail = sync[l] or i == nn
                    if i < P:
                        gid[c, q, i] = cnt + bin(below).count("1")
                    if not live[l]:
                        continue
                    tails[i] = tail
                    mb = _clip(_F(s[i]), _F(1), B)
                    prev_mb = _clip(_F(s[i - 1]), _F(1), B)
                    mbe = (_F(1) if prev_sync else prev_mb) if sync[l] \
                        else mb
                    stage = _F(1) if sync[l] else mb
                    Ai, Ap, Wi = tA[i], tA[i - 1], tW[i]
                    src = int(SKIP[c, i])
                    same = src >= 0 and src > lastb
                    Asrc = tA[min(max(src, 0), P - 1)]
                    cross = _F(2) * B * Asrc if src >= 0 and not same \
                        else _F(0)
                    hf, tf = _F(head), _F(tail)
                    if head and tail:
                        hold_a = B * Asrc if same else _F(0)
                        x[:, i] = (
                            tCA[i],
                            (hf * B) * Ap + (tf * B) * Ai + Wi * _F(1)
                            + cross,
                            B * (Ap + Ai) + Wi * _F(1),
                            min(stage * Ai + (hf * B) * Ap + hold_a,
                                stream_buf),
                            _F(1))
                    else:
                        waves = np.ceil(B / mbe)
                        hold = mbe * Asrc if same else _F(0)
                        x[:, i] = (
                            tBF[i] / _clip(mbe * OE[c, i] / lanes,
                                           util_min, UC[c, i]),
                            (hf * B) * Ap + (tf * B) * Ai + Wi * waves
                            + cross,
                            B * (Ap + Ai) + Wi * waves,
                            stage * Ai + (hf * mbe) * Ap + hold,
                            waves)
                if sb:
                    last = base + sb.bit_length() - 1
                cnt += bin(sb).count("1")
                sync_top = bool(sb >> 31)
            # each group from its head to its tail, its index the tails
            # before its head; then its roofline time
            gv = np.full((6, P + 1), np.nan, _F)
            lr = np.full(P + 1, np.nan, _F)
            for i in range(1, nn + 1):
                if not (i == 1 or tails[i - 1]):
                    continue
                t = i + int(np.argmax(tails[i:]))
                acc = [_F(0)] * 5
                for j in range(i, t + 1):
                    acc = [a + b for a, b in zip(acc, x[:, j])]
                single = t == i
                g = int(tails[:i].sum())
                gv[:5, g] = list(x[:4, i]) + [_F(1)] if single else acc
                gv[5, g] = t - i + 1
                Cg, Tg, Og, _, Wg = gv[:5, g]
                lr[g] = _maxp(_maxp(Cg, Tg / h[3]), Og / h[4]) \
                    + (Wg * h[7] + h[8])
            ng = int(tails.sum())
            la = tr = pk = _F(0)
            for g in range(ng):
                la = la + lr[g]
                tr = tr + gv[1, g]
                pk = _maxp(pk, gv[3, g])
            lat[c, q], traf[c, q], peak_o[c, q] = la, tr, pk
            valid[c, q] = pk <= budget[c]
            ngroups[c, q] = ng
            mats[:, c, q, :ng] = gv[:, :ng]
    return (lat, peak_o, traf, valid, ngroups), mats, gid


@pytest.mark.parametrize("nmax,names", [(64, ("tiny_cnn", "mnasnet")),
                                        (54, ("tiny_cnn", "mnasnet")),
                                        (19, ("tiny_cnn", "resnet18"))])
def test_kernel_algorithm_emulation_matches_twin(nmax, names):
    """Two 32-position chunks, the second partial at nmax 54, where
    mnasnet's last layer sits at position P - 1, as resnet18's does in one
    chunk at nmax 19."""
    rng = np.random.default_rng(3)
    strats = np.stack([np.stack([
        tcm.random_strategy(rng, TCNN[w]().n, nmax, 16,
                            p_sync=P_SYNC[j % len(P_SYNC)])
        for j in range(5)]) for w in names for _ in range(2)])
    parts = ("edge", "datacenter")
    wls = tcm.stack_workloads([
        tcm.pack_workload(TCNN[w](), taccel.ACCEL_ZOO["edge"], nmax,
                          device=CPU) for w in names for _ in parts])
    hw = taccel.stack_hw([taccel.ACCEL_ZOO[p] for _ in names for p in parts],
                         4, CPU)
    budgets = torch.tensor([2 * MB, 8 * MB, 2 * MB, 8 * MB])
    args = fe.kernel_args(wls, torch.as_tensor(strats),
                          torch.full((4,), 16.0), hw)
    want = fe.fusion_eval(fe.Form.RAW, args, budgets)
    cost, mats, gid = _emulate((*args, budgets))
    for k, a in zip(want[0]._fields, cost):
        np.testing.assert_array_equal(a, to_np(getattr(want[0], k)), k)
    for a, b in zip(mats, want[1:7]):
        np.testing.assert_array_equal(a, to_np(b))
    np.testing.assert_array_equal(gid, to_np(want[7]))


# -- the host path -----------------------------------------------------------

@pytest.mark.parametrize("C,POP,P,want", [(120, 40, 64, 8), (120, 36, 64, 8),
                                          (120, 1, 64, 1), (120, 133, 64, 32),
                                          (2, 40, 32, 1), (120, 133, 512, 8)])
def test_tile_fills_the_card_within_shared_memory(C, POP, P, want):
    sms = 132
    tile = fe.tile_for(C, POP, P, sms)
    assert tile == want
    assert fe.smem_bytes(P, tile) <= fe.SMEM_LIMIT
    if tile < fe.MAX_TILE and tile < POP \
            and fe.smem_bytes(P, 2 * tile) <= fe.SMEM_LIMIT:
        assert C * -(-POP // (2 * tile)) < 4 * sms


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


FAULTS = {
    "A dtype": ("A", lambda t: t.double()),
    "W shape": ("W", lambda t: t[:, :-1]),
    "OE device": ("OE", _meta),
    "UC layout": ("UC", lambda t: t.t().contiguous().t()),
    "SKIP dtype": ("SKIP", lambda t: t.long()),
    "strategies dtype": ("strategies", lambda t: t.long()),
    "strategies layout": ("strategies",
                          lambda t: t.transpose(1, 2).contiguous()
                          .transpose(1, 2)),
    "budgets shape": ("budgets", lambda t: t[:1]),
    "batches shape": ("batches", lambda t: t[1:]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_cached_check_refuses_with_checks_message(fault):
    name, spoil = FAULTS[fault]
    _, strats, wls, hw, batches, budgets = _zoo(2, budgets_mb=(8,))
    s = torch.as_tensor(strats)
    inputs = {"strategies": s, "batches": batches, "budgets": budgets}
    fe.fusion_eval_grid(wls, s, batches, budgets, hw)       # now cached
    first = fe.fusion_eval_grid(wls, s, batches, budgets, hw)
    _assert_cost_equal(first, fe.fusion_eval_grid(wls, s, batches, budgets,
                                                  hw))
    if name in inputs:
        bad = spoil(inputs[name])
        inputs[name] = bad
        call_wls = wls
    else:
        bad = spoil(wls[name])
        call_wls = dict(wls, **{name: bad})
    dtype = torch.int32 if name in ("SKIP", "strategies") else torch.float32
    C, POP, P = s.shape
    shape = {"strategies": (C, POP, P), "batches": (C,),
             "budgets": (C,)}.get(name, (C, P))
    with pytest.raises((TypeError, ValueError)) as want:
        fe._check(name, bad, dtype, shape, s.device)
    with pytest.raises(want.type) as got:
        fe.fusion_eval_grid(call_wls, inputs["strategies"], inputs["batches"],
                            inputs["budgets"], hw)
    assert str(got.value) == str(want.value)
    if name not in inputs:                   # the same dict, spoiled in place
        wls[name] = bad
        with pytest.raises(want.type) as got:
            fe.fusion_eval_grid(wls, s, batches, budgets, hw)
        assert str(got.value) == str(want.value)
