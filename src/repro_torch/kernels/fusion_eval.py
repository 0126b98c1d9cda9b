"""Population fusion-strategy evaluation: the G-Sampler's hot loop.

Port of ``repro.kernels.fusion_eval`` (the Pallas ``_fe_kernel``).  The
kernel is ``csrc/fusion_eval.cu``: one CUDA block per (condition, tile of
``THREADS`` candidates), one thread per candidate strategy, sweeping the
chain positions in order and writing each fused group to its column as it
closes.  It emits the per-group decomposition ``C_g, T_g, O_g, M_g,
wave_g, glen`` (f32) and ``gid`` (i32), each ``[C, POP, P]``; the CostOut
reduction runs outside it, through ``cost_model.finalize_groups``.

:func:`fusion_eval_grid_stats_plain` is the same sweep in plain PyTorch,
vectorised over ``[C, POP]``: the kernel's oracle on the card and its path
on the CPU.  It writes each closed group with ``scatter_`` at a distinct
column per lane (no ``index_add_``/``scatter_add_``, whose CUDA atomics
sum in no fixed order) and repeats the kernel's operation order, so the
two agree bit for bit on the card.  The wrappers take the plain path only
for tensors on the CPU; for CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..core.accel import BPE, FREQ, HW_FEATURE_DIM, LANES, NPE, STREAM, \
    stack_hw

__all__ = ["fusion_eval_grid", "fusion_eval_grid_stats",
           "fusion_eval_grid_stats_plain", "fusion_eval_raw", "kernel_args",
           "compiled_backend_supported", "backend_stats", "reset_launches",
           "THREADS"]

THREADS = 128                     # candidates per CUDA block (fixed tile)
SOURCE = "fusion_eval"            # csrc/fusion_eval.cu
_UTIL_MIN = 1.0 / 4096.0
_KERNEL_KEYS = ("A", "W", "F", "OE", "UC", "SKIP", "n", "BPE")


class _Stats:
    """Launch count of the kernel and the library's build/probe state."""

    def __init__(self):
        self.launches = 0
        self.probe_ok: bool | None = None


STATS = _Stats()


def reset_launches() -> None:
    STATS.launches = 0


def backend_stats() -> dict:
    """Launches so far, the probe verdict and the library's build time."""
    info = _build.build_info(SOURCE)
    return {"launches": STATS.launches, "probe_ok": STATS.probe_ok,
            "build_s": None if info is None else info["build_s"],
            "build_cached": None if info is None else info["cached"]}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fusion_eval_launch.argtypes = [vp] * 18 + [ci] * 4 + [vp]
        lib.fusion_eval_launch.restype = ci
        lib.fusion_eval_probe.argtypes = [vp, ci, vp]
        lib.fusion_eval_probe.restype = ci
        lib._argtypes_set = True
    return lib


def compiled_backend_supported() -> bool:
    """Build the library and launch a trivial probe kernel (x * 2 over an
    [8, 128] f32 tile).  Returns True, or raises: there is no interpret
    fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError("fusion_eval: no CUDA device to build and probe "
                           "the kernel on")
    lib = _lib()
    x = torch.ones((8, 128), dtype=torch.float32, device="cuda")
    rc = lib.fusion_eval_probe(x.data_ptr(), x.numel(),
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fusion_eval probe launch failed: CUDA error {rc}")
    torch.cuda.synchronize()
    if not torch.equal(x, torch.full_like(x, 2.0)):
        raise RuntimeError("fusion_eval probe kernel computed a wrong result")
    STATS.probe_ok = True
    return True


def _check(name: str, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"fusion_eval: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"fusion_eval: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fusion_eval: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fusion_eval: {name} is on {t.device}, "
                         f"strategies on {device}")
    if not t.is_contiguous():
        raise ValueError(f"fusion_eval: {name} must be contiguous")


def kernel_args(wls: dict, strategies, batches, hw):
    """Validated kernel inputs: (strategies, A, W, F, OE, UC, SKIP, n,
    batches, BPE, hw rows)."""
    missing = [k for k in _KERNEL_KEYS if k not in wls]
    if missing:
        raise KeyError(f"packed workload missing {missing}; pack with "
                       f"cost_model.pack_workload")
    if not isinstance(strategies, torch.Tensor) or strategies.dim() != 3:
        raise ValueError("fusion_eval: strategies must be a [C, POP, P] "
                         "tensor")
    C, POP, P = strategies.shape
    dev = strategies.device
    batches = torch.as_tensor(batches, dtype=torch.float32, device=dev)
    hwr = stack_hw(hw, C, device=dev)
    f32, i32 = torch.float32, torch.int32
    _check("strategies", strategies, i32, (C, POP, P), dev)
    args = [strategies]
    for k in ("A", "W", "F", "OE", "UC"):
        _check(k, wls[k], f32, (C, P), dev)
        args.append(wls[k])
    _check("SKIP", wls["SKIP"], i32, (C, P), dev)
    _check("n", wls["n"], i32, (C,), dev)
    _check("batches", batches, f32, (C,), dev)
    _check("BPE", wls["BPE"], f32, (C,), dev)
    _check("hw", hwr, f32, (C, HW_FEATURE_DIM), dev)
    return (*args, wls["SKIP"], wls["n"], batches, wls["BPE"], hwr)


def _launch(strat, A, W, F, OE, UC, SKIP, n, batch, bpe, hw):
    C, POP, P = strat.shape
    outs = [torch.empty((C, POP, P), dtype=torch.float32, device=strat.device)
            for _ in range(6)]
    gid = torch.empty((C, POP, P), dtype=torch.int32, device=strat.device)
    if C == 0 or POP == 0 or P == 0:
        return (*outs, gid)
    lib = _lib()
    ptrs = [t.data_ptr() for t in (strat, A, W, F, OE, UC, SKIP, n, batch,
                                   bpe, hw, *outs, gid)]
    with torch.cuda.device(strat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fusion_eval_launch(*ptrs, C, POP, P, THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"fusion_eval kernel launch failed: CUDA error "
                           f"{rc}")
    STATS.launches += 1
    return (*outs, gid)


def fusion_eval_grid_stats_plain(strat, A, W, F, OE, UC, SKIP, n, batch, bpe,
                                 hw):
    """The kernel's sweep in plain PyTorch, vectorised over [C, POP].

    Same inputs and outputs as the kernel (see the module docstring); every
    expression keeps the kernel's operation order."""
    C, POP, P = strat.shape
    dev, f32 = strat.device, torch.float32
    s = strat.to(f32)
    B = batch.view(C, 1)
    col = lambda k: hw[:, k:k + 1]                         # [C, 1]
    lanes = col(NPE) * col(LANES)
    peak_macs = lanes * col(FREQ)
    stream_buf = col(STREAM)
    scale = col(BPE) / bpe.view(C, 1)
    A = A * scale
    W = W * scale
    nn_ = n.view(C, 1)

    def util(mbe, oe, uc):
        return torch.minimum(torch.clamp_min(mbe * oe / lanes, _UTIL_MIN), uc)

    zeros = torch.zeros((C, POP), dtype=f32, device=dev)
    # one spare column (P) takes the writes of lanes that close no group
    outs = [torch.zeros((C, POP, P + 1), dtype=f32, device=dev)
            for _ in range(6)]
    gid = torch.zeros((C, POP, P), dtype=torch.int32, device=dev)
    g_comp = g_traf = g_on = g_mem = g_wav = g_len = zeros
    scount = torch.zeros((C, POP), dtype=torch.int64, device=dev)
    prev_sync = torch.zeros((C, POP), dtype=torch.bool, device=dev)
    prev_mb = torch.minimum(torch.clamp_min(s[..., 0], 1.0), B)
    lastb = torch.full((C, POP), -1.0, dtype=f32, device=dev)
    spare = torch.full((C, POP), P, dtype=torch.int64, device=dev)
    Bfull = B.expand(C, POP)

    for i in range(1, P):
        a = s[..., i]
        live = i <= nn_                                    # [C, 1]
        Ai, Ap, Wi, Fi = A[:, i:i + 1], A[:, i - 1:i], W[:, i:i + 1], \
            F[:, i:i + 1]
        OEi, UCi = OE[:, i:i + 1], UC[:, i:i + 1]
        src = SKIP[:, i:i + 1].long()
        gid[..., i] = scount.to(torch.int32)
        sync = (a < 0.0) & live
        mb = torch.minimum(torch.clamp_min(a, 1.0), B)
        mbe = torch.where(sync, torch.where(prev_sync, 1.0, prev_mb), mb)
        stage = torch.where(sync, 1.0, mb)
        head = g_len == 0.0

        has_skip = src >= 0
        same = has_skip & (src.to(f32) > lastb)
        Asrc = torch.gather(A, 1, src.clamp(0, P - 1))     # [C, 1]
        hold = torch.where(same, mbe * Asrc, 0.0)
        cross_t = torch.where(has_skip & ~same, 2.0 * B * Asrc, 0.0)

        is_tail = (sync | (i == nn_)) & live
        waves = torch.ceil(B / mbe)
        head_f = torch.where(head, 1.0, 0.0)
        tail_f = torch.where(is_tail, 1.0, 0.0)
        mem_i = stage * Ai + (head_f * mbe) * Ap + hold
        traf_i = (head_f * B) * Ap + (tail_f * B) * Ai + Wi * waves + cross_t
        comp_i = B * Fi / peak_macs / util(mbe, OEi, UCi)
        on_i = B * (Ap + Ai) + Wi * waves

        hold_a = torch.where(same, B * Asrc, 0.0)
        mem_a = torch.minimum(stage * Ai + (head_f * B) * Ap + hold_a,
                              stream_buf)
        comp_a = B * Fi / peak_macs / util(Bfull, OEi, UCi)
        traf_a = (head_f * B) * Ap + (tail_f * B) * Ai + Wi * 1.0 + cross_t
        on_a = B * (Ap + Ai) + Wi * 1.0

        lv = torch.where(live, 1.0, 0.0)
        g_comp = g_comp + comp_i * lv
        g_traf = g_traf + traf_i * lv
        g_on = g_on + on_i * lv
        g_mem = g_mem + mem_i * lv
        g_wav = g_wav + waves * lv
        g_len = g_len + lv

        single = g_len == 1.0
        closed = (torch.where(single, comp_a, g_comp),
                  torch.where(single, traf_a, g_traf),
                  torch.where(single, on_a, g_on),
                  torch.where(single, mem_a, g_mem),
                  torch.where(single, 1.0, g_wav),
                  g_len)
        idx = torch.where(is_tail, scount, spare).unsqueeze(-1)
        for out, val in zip(outs, closed):
            out.scatter_(2, idx, val.unsqueeze(-1))

        rz = lambda x: torch.where(is_tail, 0.0, x)
        g_comp, g_traf, g_on = rz(g_comp), rz(g_traf), rz(g_on)
        g_mem, g_wav, g_len = rz(g_mem), rz(g_wav), rz(g_len)
        scount = scount + sync.long()
        lastb = torch.where(sync, float(i), lastb)
        prev_sync = sync
        prev_mb = mb

    return (*(o[..., :P].contiguous() for o in outs), gid)


def fusion_eval_raw(strat, A, W, F, OE, UC, SKIP, n, batch, bpe, hw):
    """The seven group matrices: the kernel for CUDA tensors, the plain
    twin for CPU tensors."""
    if strat.is_cuda:
        return _launch(strat, A, W, F, OE, UC, SKIP, n, batch, bpe, hw)
    if strat.device.type != "cpu":
        raise ValueError(f"fusion_eval: no kernel for device {strat.device}")
    return fusion_eval_grid_stats_plain(strat, A, W, F, OE, UC, SKIP, n,
                                        batch, bpe, hw)


def fusion_eval_grid_stats(wls: dict, strategies, batches, budgets, hw):
    """``(CostOut [C, POP], gid [C, POP, P], M_g [C, POP, P])`` for
    strategies [C, POP, P] (int32) over stacked packed workloads,
    per-condition ``batches``/``budgets`` [C] and per-condition hardware
    (anything ``accel.stack_hw`` accepts)."""
    from ..core.cost_model import finalize_groups
    args = kernel_args(wls, strategies, batches, hw)
    C_g, T_g, O_g, M_g, wave_g, glen, gid = fusion_eval_raw(*args)
    budgets = torch.as_tensor(budgets, dtype=torch.float32,
                              device=strategies.device)
    out = finalize_groups(C_g, T_g, O_g, M_g, wave_g, glen,
                          budgets[:, None], args[-1][:, None, :])
    return out, gid, M_g


def fusion_eval_grid(wls: dict, strategies, batches, budgets, hw):
    """CostOut [C, POP]; see :func:`fusion_eval_grid_stats`."""
    out, _, _ = fusion_eval_grid_stats(wls, strategies, batches, budgets, hw)
    return out
