"""Roofline terms of a sharded step from the plan (the port's counterpart
of ``repro.launch.hlo_analysis``).

The reference parses collective bytes out of the optimized HLO of a
GSPMD compile and prices the terms on TPU v5e constants.  The port
compiles nothing: its FLOPs come from ``torch.utils.flop_counter`` over
the step on ``meta`` tensors (``launch.dryrun``), and its collective
bytes are reckoned here **analytically** from the sharding plan
(``distributed.sharding``), per device and per step:

- FSDP: an all-gather of every data-sharded leaf at each use (forward,
  and again in the backward of a train step) and a reduce-scatter of its
  gradient; a train step all-reduces the gradient of a leaf the plan
  does not shard over 'data';
- TP, EP and SP: :func:`parallel_payloads`, the collectives that the
  port's sharded steps make (``distributed.tp``), layer by layer, each
  a payload of the size that step moves on a rank.  The CPU tests hold
  it equal to the bytes that the executed train, prefill and decode
  steps count (``tp.Parallel.moved``) on gloo ranks.

Each payload is the collective's full buffer on one device, times the
reference's ``_WIRE_FACTOR`` (2 for an all-reduce, its reduce and
broadcast phases; 1 otherwise), the same ~2x-exact convention the
reference applies to its HLO result shapes.  These are predictions, not
measurements.

Hardware constants (``HW``) are an H100 SXM's datasheet peaks (NVIDIA
H100 Tensor Core GPU datasheet, SXM5 column): dense BF16 989e12 FLOP/s,
FP32 67e12 FLOP/s, HBM3 3.35e12 B/s, NVLink 4 900e9 B/s both directions
(450e9 a direction).  An axis that spans more than the 8 GPUs of one
NVLink domain crosses nodes; there the rate is one 400 Gb/s InfiniBand
NDR port a GPU, 50e9 B/s (the DGX H100's eight ConnectX-7 ports).
"""
from __future__ import annotations

import math
import re
from dataclasses import asdict, dataclass

import torch

from .mesh import axis_sizes, dp_axes

__all__ = ["HW", "collective_bytes", "roofline_terms", "RooflineReport",
           "link_rate", "peak_flops", "parallel_payloads"]

HW = dict(peak_flops_bf16=989e12, peak_flops_f32=67e12, hbm_bw=3.35e12,
          nvlink_bw=450e9, ib_bw=50e9, nvlink_domain=8)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}



def peak_flops(dtype) -> float:
    """The datasheet's dense peak for a compute type (bf16/f16 on the
    tensor cores, f32 on the CUDA cores)."""
    return HW["peak_flops_f32"] if dtype == torch.float32 \
        else HW["peak_flops_bf16"]


def link_rate(mesh) -> float:
    """The per-direction rate a collective of ``mesh`` sees: NVLink when
    the whole mesh fits one 8-GPU domain, else the inter-node link."""
    n = math.prod(axis_sizes(mesh).values())
    return HW["nvlink_bw"] if n <= HW["nvlink_domain"] else HW["ib_bw"]


def _has(spec: tuple, axes) -> bool:
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a in axes:
                return True
    return False


def collective_bytes(specs: dict, leaves: dict, cfg, shape, mesh, *,
                     act_bytes: int) -> dict[str, float]:
    """Per-device collective wire bytes of one step, by kind (module
    docstring).  ``specs``/``leaves``: ``param_tree``-keyed specs and
    (``meta``) tensors of the whole model; ``act_bytes`` the activations'
    element size."""
    sizes = axis_sizes(mesh)
    dps = dp_axes(mesh)
    dp = math.prod(sizes[a] for a in dps)
    tp = sizes["model"]
    train = shape.kind == "train"
    uses = 2 if train else 1
    out = {k: 0.0 for k in _COLLECTIVES}

    def add(kind, nbytes):
        out[kind] += nbytes * _WIRE_FACTOR[kind]

    for k, t in leaves.items():
        spec = specs[k]
        full = t.numel() * t.element_size()
        local = full / tp if "model" in spec else full
        if dp > 1:
            if _has(spec, dps):
                for _ in range(uses):
                    add("all-gather", local)
                if train:
                    add("reduce-scatter", local)
            elif train:
                add("all-reduce", local)
    for (_, kind), nbytes in parallel_payloads(
            cfg, shape, mesh, act_bytes=act_bytes).items():
        add(kind, nbytes)
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


def parallel_payloads(cfg, shape, mesh, *, act_bytes: int) -> dict:
    """``{(part, kind): bytes}`` one rank's TP, EP and SP collectives move
    in one step of ``shape`` (before ``_WIRE_FACTOR``), as the port's
    sharded steps make them: ``part`` is ``"tp"``, ``"ep"`` or ``"sp"``;
    an all-reduce counts its tensor, an all-gather its output, an
    all-to-all its input (``distributed.tp``).  A train step recomputes
    each block (``remat="full"``, and ``"dots"``, whose recompute runs
    the same collectives), so a block's forward collectives count
    twice, but for those after the block's last saved tensor, where the
    non-reentrant checkpoint stops its recompute: the MLP's row-parallel
    sum that ends a block, and the rows all-gathered after an
    expert-parallel MoE layer.  The payloads are the same in bf16 (at
    ``act_bytes=2``): the f32 leaves a bf16 model keeps are replicated
    over 'model', and their data-parallel gradient sums are FSDP's part
    (:func:`collective_bytes`, an all-reduce of a replicated leaf).  ``act_bytes`` is the size of the
    activations and parameters.  A prefill's prompt is ``seq_len`` tokens
    (whisper's: ``seq_len`` encoder frames and ``seq_len // 8`` decoder
    tokens)."""
    from collections import Counter
    from ..models.registry import decode_cache_len
    from ..nn.losses import CHUNK
    from ..nn.moe import capacity
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in dp_axes(mesh))
    t = sizes["model"]
    kind, B = shape.kind, shape.global_batch
    b = B if B % dp else B // dp
    a, f = act_bytes, 4
    d, hd = cfg.d_model, cfg.hd
    out = Counter()
    sh = lambda n: t > 1 and n % t == 0
    q_sh, kv_sh = sh(cfg.n_heads), sh(cfg.kv_heads)
    train = kind == "train"
    fwd = 2 if train else 1                 # remat="full": twice a block

    def ar(part, n, times=1):
        out[(part, "all-reduce")] += n * times

    S, sp = shape.seq_len, 1
    if kind == "decode":
        S = 1
        sp = t * (dp if B == 1 and dp > 1 else 1)
        sp = sp if sp > 1 and decode_cache_len(cfg, shape) % sp == 0 else 1
    enc = shape.seq_len if cfg.family == "encdec" else 0   # encoder frames
    if cfg.family == "encdec" and kind != "decode":
        S = max(enc // 8, 8)

    def attention(rows, kv_rows=None, cache=True):
        """A self-attention (``kv_rows`` None; with a decode cache unless
        ``cache`` is False) or cross-attention layer over ``rows`` query
        tokens."""
        cross = kv_rows is not None
        if q_sh:
            ar("tp", rows * d * a, fwd)                       # o
        if q_sh and train:
            ar("tp", rows * d * a)                            # copy of x
            if cross and kv_sh:
                ar("tp", kv_rows * d * a)                     # of memory
            if cfg.qk_norm:
                ar("tp", hd * a * (2 if kv_sh else 1))        # gains
            if not kv_sh:                                     # the veto
                ar("tp", (kv_rows or rows) * cfg.kv_heads * hd * a, 2)
        if cross or kind == "train" or not cache:
            return
        if kv_sh:                                             # cache write
            out[("sp", "all-gather")] += 2 * rows * cfg.kv_heads * hd * a
        if kind == "decode":
            if q_sh:
                out[("sp", "all-gather")] += rows * cfg.n_heads * hd * a
            if sp > 1:
                out[("sp", "all-gather")] += sp * rows * cfg.n_heads \
                    * (hd + 1) * f

    def mlp(rows, width=cfg.d_ff, times=1):
        if sh(width):
            ar("tp", rows * d * a, times)
            if train:
                ar("tp", rows * d * a)

    def moe(rows_b, seq):
        E, k = cfg.n_experts, cfg.moe_top_k
        C = capacity(seq, k, E, cfg.capacity_factor)
        if sh(E):
            Bl = -(-rows_b // t)
            slots = Bl * E * C * d * a
            out[("ep", "all-to-all")] += 2 * slots * fwd
            out[("ep", "all-gather")] += t * Bl * seq * d * a
            if train:
                out[("ep", "all-to-all")] += 2 * slots
                ar("ep", Bl * t * seq * (d + k) * a)
        elif sh(cfg.d_ff):
            ar("tp", rows_b * E * C * d * a, fwd)
            if train:
                ar("tp", rows_b * E * C * d * a)

    def rwkv(rows):
        n = hd
        if sh(cfg.n_heads):
            ar("tp", rows * d * a, fwd)                       # o
            if train:
                ar("tp", rows * d * a, 4)                     # r, k, v, g
                ar("tp", rows * d * f + cfg.n_heads * n * f)  # w, u
                ar("tp", n * a, 2)                            # gn g, b
        mlp(rows, times=fwd)                                  # ck, cv
        if sh(d):                                             # cr
            out[("tp", "all-gather")] += rows * d * a * fwd
            if train:
                ar("tp", rows * d * a)

    def vocab(rows, n_rows):
        if sh(n_rows):
            ar("tp", rows * d * a)

    T = b * S
    if cfg.family == "encdec":
        vocab(T, cfg.vocab_padded)
        vocab(S, 4096 + 8)                    # positions, not batched
        for _ in range(cfg.encoder_layers if kind != "decode" else 0):
            attention(b * enc, cache=False)
            mlp(b * enc)
        for _ in range(cfg.n_layers):
            attention(T)
            attention(T, b * enc if kind != "decode" else
                      b * 8 * decode_cache_len(cfg, shape))
            mlp(T)
    else:
        if not cfg.embed_inputs:
            vocab(T, cfg.vocab_padded)
        for _ in range(cfg.n_layers):
            if cfg.family == "ssm":
                rwkv(T)
                continue
            attention(T)
            if cfg.n_experts:
                moe(b, S)
            else:
                mlp(T)
    if sh(cfg.vocab_padded):
        if train:
            ar("tp", T * d * a)                               # copy of x
            nc = -(-S // CHUNK)
            rows = b * S if S <= CHUNK else 2 * b * nc * CHUNK
            ar("tp", rows * f + 2 * rows * f)                 # max, (se, ll)
        else:
            out[("tp", "all-gather")] += b * cfg.vocab_padded * a
    return dict(out)


def _flat(tree: dict) -> list:
    res = []
    for v in tree.values():
        res.extend(_flat(v) if isinstance(v, dict) else [v])
    return res


@dataclass
class RooflineReport:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float      # MODEL_FLOPS / (flops per device x n_devices)

    def as_dict(self):
        return asdict(self)


def roofline_terms(*, flops: float, bytes_accessed: float,
                   coll_bytes: float, n_devices: int,
                   model_flops: float = 0.0, peak: float | None = None,
                   link: float | None = None) -> RooflineReport:
    """The three times of one step on one device (all inputs per device):
    FLOPs over ``peak`` (default the bf16 peak), bytes over HBM, wire
    bytes over ``link`` (default NVLink, one direction)."""
    t_c = flops / (peak or HW["peak_flops_bf16"])
    t_m = bytes_accessed / HW["hbm_bw"]
    t_x = coll_bytes / (link or HW["nvlink_bw"])
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bn = max(terms, key=terms.get)
    useful = (model_flops / (flops * n_devices)) if flops else 0.0
    return RooflineReport(flops, bytes_accessed, coll_bytes, t_c, t_m, t_x,
                          bn, model_flops, useful)
