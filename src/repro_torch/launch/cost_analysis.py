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
- TP: an all-reduce of the output of every row-parallel leaf (``o/w``,
  ``down/w``, RWKV's ``o``/``cv``, expert-TP ``down``) forward, and of
  its input gradient backward; the vocab-parallel embedding's output and
  the CE's two per-token statistics;
- EP: the MoE dispatch and combine all-to-alls of each expert-parallel
  layer;
- SP: the decode merge of each attention layer whose cache is sharded on
  its sequence axis (partial outputs and the two softmax statistics).

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
           "link_rate", "peak_flops"]

HW = dict(peak_flops_bf16=989e12, peak_flops_f32=67e12, hbm_bw=3.35e12,
          nvlink_bw=450e9, ib_bw=50e9, nvlink_domain=8)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

_ROW_PARALLEL = re.compile(r"(^|/)((attn|xattn)/o/w|mlp/down/w|o/w|cv/w|"
                           r"moe/down)$")


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
                     act_bytes: int, state_specs: dict | None = None
                     ) -> dict[str, float]:
    """Per-device collective wire bytes of one step, by kind (module
    docstring).  ``specs``/``leaves``: ``param_tree``-keyed specs and
    (``meta``) tensors of the whole model; ``act_bytes`` the activations'
    element size; ``state_specs`` the decode state's specs (SP)."""
    sizes = axis_sizes(mesh)
    dps = dp_axes(mesh)
    dp = math.prod(sizes[a] for a in dps)
    tp = sizes["model"]
    train = shape.kind == "train"
    uses = 2 if train else 1
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        tok = max(B // dp, 1)
    else:
        tok = B * S / dp
    d = cfg.d_model
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
        if tp > 1 and "model" in spec:
            path = re.sub(r"^(blocks|enc_blocks|dec_blocks)/\d+/", r"\1/", k)
            if _ROW_PARALLEL.search(path) and not (
                    path.endswith("moe/down") and spec.index("model") == 0):
                for _ in range(uses):
                    add("all-reduce", tok * d * act_bytes)
            if path.endswith("moe/down") and spec.index("model") == 0:
                for _ in range(uses):                   # EP dispatch+combine
                    add("all-to-all", 2 * tok * cfg.moe_top_k * d
                        * act_bytes)
            if path in ("embed/emb", "tok/emb"):
                add("all-reduce", tok * d * act_bytes)
            if path == "head/w" or (path == "embed/emb"
                                    and cfg.tie_embeddings):
                for _ in range(uses):
                    add("all-reduce", tok * 2 * 4)
    if state_specs is not None and shape.kind == "decode":
        kv = [s for s in _flat(state_specs) if len(s) >= 5]
        sharded = [s for s in kv if s[2] is not None]
        if sharded:
            layers = cfg.n_layers
            part = tok * cfg.n_heads * (cfg.hd + 2) * 4
            add("all-reduce", layers * part)
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


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
