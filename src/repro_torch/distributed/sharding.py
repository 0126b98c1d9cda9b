"""Partitioning rules: DP/FSDP x TP x EP x SP on the (pod, data, model)
mesh (port of ``repro.distributed.sharding``).

Strategy (the reference's):
 - TP ("model" axis): attention head projections, the MLP hidden dim, the
   vocab dim of embeddings and heads, and the expert axis of MoE stacks
   (EP == TP axis: experts live where their weights live).
 - FSDP (the "data"/"pod" axes): every parameter also shards its largest
   remaining dim over the data axes (ZeRO-3).
 - Batch dims of inputs shard over (pod, data).  SP: decode caches with a
   global batch below the data-parallel size shard the *sequence* axis
   instead (long_500k).

A spec is a tuple with one entry per dim of the leaf: ``None``, an axis
name, or a tuple of axis names; ``()`` replicates the leaf.  It equals
the reference's ``PartitionSpec`` entry for entry.  The rules match
regexes on the reference's pytree paths, whose block leaves are stacked
on a leading layer axis (``blocks/attn/q/w`` [L, d, Hq*hd]); the port's
parameters are per layer (``blocks/3/attn/q/w``, as ``core.model.
param_tree`` keys them), so :func:`param_specs` rules each leaf at its
stacked path and shape and drops the layer axis's entry.  The port's
decode states are stacked as the reference's (``k``/``v`` [L, B, T, kvh,
hd]); only their write index is a host int, which has no spec.

:func:`to_placements` turns a spec into DTensor placements on a
``DeviceMesh``.  :func:`data_parallel_mesh`, :func:`replicate_tree` and
:func:`shard_leading_axis` place the mapper's trainer and serving
replicas.
"""
from __future__ import annotations

import math
import re

import torch

from ..launch.mesh import (_AMBIENT, axis_sizes, batch_axes, dp_axes,
                           init_mesh)

__all__ = ["shard_spec_for_path", "param_specs", "batch_specs",
           "decode_state_specs_sharded", "logical_shard", "ambient_mesh",
           "data_parallel_mesh", "replicate_tree", "shard_leading_axis",
           "to_placements", "stacked_path", "shard_bytes"]

_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def data_parallel_mesh(n_devices: int | None = None, *, device=None):
    """A 1-D ``("data",)`` ``DeviceMesh`` over the process group: the
    mapper trainer's mesh.  ``n_devices`` defaults to the group's world
    size and must equal it; ``device`` (``cuda`` unless ``"cpu"``) gives
    the mesh's device type.  Raises without a process group
    (``launch.mesh.process_group`` opens one for a single process)."""
    import torch.distributed as dist
    from .. import resolve_device
    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("data_parallel_mesh: no process group is "
                           "initialised (launch.mesh.process_group opens "
                           "one for a single process)")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return init_mesh((n,), ("data",), dev.type)


def replicate_tree(tree, devices) -> list:
    """One copy of ``tree`` (a dict of tensors, nested dicts allowed) per
    device of ``devices``: the serving replicas' parameter placement.  A
    leaf already on a device is shared, not copied."""
    def put(x, d):
        if isinstance(x, dict):
            return {k: put(v, d) for k, v in x.items()}
        return x.to(d) if isinstance(x, torch.Tensor) else x
    return [put(tree, torch.device(d)) for d in devices]


def shard_leading_axis(tree, n: int) -> list:
    """``tree`` (a dict of tensors or arrays) cut into ``n`` contiguous
    blocks along every leaf's leading axis: block ``i`` is replica
    ``i``'s share.  Every leading dim must divide by ``n``."""
    def cut(x):
        if x.ndim == 0 or x.shape[0] % n:
            raise ValueError(
                f"cannot shard leading axis of shape {tuple(x.shape)}"
                f" over {n} replicas; pad the tick to a multiple of {n}")
        m = x.shape[0] // n
        return [x[i * m:(i + 1) * m] for i in range(n)]
    cuts = {k: cut(v) for k, v in tree.items()}
    return [{k: c[i] for k, c in cuts.items()} for i in range(n)]


def ambient_mesh():
    """The mesh of the innermost ``launch.mesh.mesh_ctx``, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def logical_shard(x, *dims):
    """In-model sharding constraint with logical dim names ("batch",
    "model", "seq", None): returns ``x``.  The reference's GSPMD needs
    the constraint to place its collectives; the port's modules hold
    their shards as plain tensors and make each collective explicitly
    where the reference constrains a layout (``distributed.tp``: the MoE
    all-to-alls in ``nn.moe``, the vocab-parallel statistics in
    ``nn.losses``, the RWKV heads in ``nn.rwkv``), so there is no layout
    left to constrain."""
    return x


# (regex, (tp_dim_from_end, fsdp_dim_from_end)) -- dims counted from the END
# of the shape so the rules are indifferent to the stacked-layer axis.
# tp None => no TP; fsdp None => no FSDP shard.
_RULES: list[tuple[str, tuple[int | None, int | None]]] = [
    (r"(^|/)embed/emb$",              (-2, -1)),   # [V, d]: V->model, d->data
    (r"(^|/)(tok|pos)/emb$",          (-2, -1)),
    (r"(^|/)head/w$",                 (-1, -2)),   # [d, V]: V->model
    (r"(^|/)(attn|xattn)/(q|k|v)/w$", (-1, -2)),   # [d, Hh]: heads->model
    (r"(^|/)(attn|xattn)/(q|k|v)/b$", (-1, None)),
    (r"(^|/)(attn|xattn)/o/w$",       (-2, -1)),   # [Hh, d]
    (r"(^|/)mlp/(gate|up)/w$",        (-1, -2)),   # [d, f]
    (r"(^|/)mlp/(gate|up)/b$",        (-1, None)),
    (r"(^|/)mlp/down/w$",             (-2, -1)),   # [f, d]
    # [E, d, f]: EP (E->model) when E divides tp; else expert-TP (f->model)
    (r"(^|/)moe/(gate|up)$",          (-3, -1)),
    (r"(^|/)moe/down$",               (-3, -1)),
    (r"(^|/)moe_tp/(gate|up)$",       (-1, -2)),   # rewritten rule target
    (r"(^|/)moe_tp/down$",            (-2, -1)),
    (r"(^|/)moe/router/w$",           (None, None)),
    # rwkv time/channel mix
    (r"(^|/)(r|k|v|g|cr|ck)/w$",      (-1, -2)),
    (r"(^|/)(o|cv)/w$",               (-2, -1)),
    (r"(^|/)(w1|w2)/w$",              (None, -1)),
    # hymba ssm: small per-channel params, replicate
    (r"(^|/)ssm/",                    (None, None)),
]


# Paths whose TP shard is only legal when the HEAD COUNT (not the packed
# feature dim) divides the TP size: sharding [d, H*hd] when H < tp would
# split head_dim and turn every attention contraction into an all-reduce.
# When heads don't divide, the projection is replicated across 'model'
# (Megatron GQA practice) and FSDP still shards its storage.
_Q_PATHS = re.compile(r"(^|/)(attn|xattn)/(q/w|q/b|o/w)$")
_KV_PATHS = re.compile(r"(^|/)(attn|xattn)/(k|v)/(w|b)$")
_RWKV_HEAD_PATHS = re.compile(r"(^|/)(r|k|v|g|o)/w$")


def shard_spec_for_path(path_str: str, shape: tuple[int, ...], mesh,
                        cfg=None) -> tuple:
    """Spec of one parameter leaf at its reference path and (stacked)
    shape, divisibility-checked: the reference's ``PartitionSpec`` as a
    tuple."""
    sizes = axis_sizes(mesh)
    fsdp = dp_axes(mesh)
    fsdp_size = math.prod(sizes[a] for a in fsdp)
    tp_size = sizes["model"]
    ndim = len(shape)
    spec = [None] * ndim

    tp_vetoed = False
    if cfg is not None:
        if _Q_PATHS.search(path_str) and cfg.n_heads % tp_size:
            tp_vetoed = True
        if _KV_PATHS.search(path_str) and "attn" in path_str \
                and cfg.kv_heads % tp_size:
            tp_vetoed = True
        if cfg.family == "ssm" and _RWKV_HEAD_PATHS.search(path_str) \
                and cfg.n_heads % tp_size:
            tp_vetoed = True
        # grok-style MoE (E=8 < tp=16): fall back to Megatron expert-TP --
        # shard each expert's hidden dim instead of the expert axis.
        if "/moe/" in path_str and cfg.n_experts % tp_size:
            path_str = path_str.replace("/moe/", "/moe_tp/")

    for pat, (tp_d, fs_d) in _RULES:
        if re.search(pat, path_str):
            if tp_d is not None and -tp_d <= ndim \
                    and shape[tp_d] % tp_size == 0 and not tp_vetoed:
                spec[ndim + tp_d] = "model"
            if fs_d is not None and -fs_d <= ndim \
                    and spec[ndim + fs_d] is None \
                    and shape[fs_d] % fsdp_size == 0:
                spec[ndim + fs_d] = fsdp if len(fsdp) > 1 else fsdp[0]
            return tuple(spec)
    return ()      # norms, scalars, unmatched -> replicated


def stacked_path(key: str) -> tuple[str, bool]:
    """``(reference path, stacked?)`` of a ``param_tree`` key:
    ``blocks/3/attn/q/w`` -> ``("blocks/attn/q/w", True)``."""
    parts = key.split("/")
    if len(parts) > 2 and parts[0] in _STACKS and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), True
    return key, False


def param_specs(model, mesh, cfg=None) -> dict:
    """``{param_tree key: spec}`` of a model (or of a ``param_tree``-keyed
    dict of tensors, ``meta`` ones included): each per-layer leaf ruled at
    its stacked reference path and shape ``(L, *shape)``, the layer
    axis's entry dropped."""
    if isinstance(model, dict):
        leaves = model
    else:
        from ..core.model import param_tree
        leaves = param_tree(model)
    layers: dict[str, set] = {}
    for k in leaves:
        if stacked_path(k)[1]:
            group, index = k.split("/")[:2]
            layers.setdefault(group, set()).add(index)
    out = {}
    for k, v in leaves.items():
        path, stacked = stacked_path(k)
        shape = tuple(v.shape)
        if not stacked:
            out[k] = shard_spec_for_path(path, shape, mesh, cfg)
            continue
        L = len(layers[k.split("/")[0]])
        spec = shard_spec_for_path(path, (L,) + shape, mesh, cfg)
        if spec and spec[0] is not None:
            raise AssertionError(f"{k}: the plan shards the layer axis "
                                 f"({spec})")
        out[k] = spec[1:]
    return out


def batch_specs(batch: dict, mesh, *, shard_seq: bool = False) -> dict:
    """Specs of a model-input batch: the leading batch dim over (pod,
    data); with ``shard_seq`` (long context, batch below the data-parallel
    size) dim 1 (the sequence) instead."""
    ba = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_size = math.prod(sizes[a] for a in dp_axes(mesh))

    def spec(x):
        if x.ndim == 0:
            return ()
        if shard_seq and x.ndim >= 2 and x.shape[0] == 1 \
                and x.shape[1] % dp_size == 0:
            return (None, ba, *([None] * (x.ndim - 2)))
        if x.shape[0] % dp_size:
            return ()                      # batch-1 decode: replicate
        return (ba, *([None] * (x.ndim - 1)))
    return {k: spec(v) for k, v in batch.items()}


def decode_state_specs_sharded(state: dict, mesh, *,
                               shard_seq: bool = False) -> dict:
    """Specs of a decode state (caches [L, B, T, kvh, hd], RWKV/SSM
    states [L, B, ...], whisper's encoder ``memory`` [B, T, d]).

    Normal decode: batch over (pod, data) AND the cache sequence axis over
    'model' (distributed flash-decode; kv-head counts are below the TP
    size for every GQA arch, so the head axis cannot carry the shard).
    SP mode (``shard_seq``, long-context batch 1): the sequence axis
    shards over 'data' and 'model'.  A host int (the write index) gets
    ``()``."""
    ba = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_size = math.prod(sizes[a] for a in dp_axes(mesh))
    tp = sizes["model"]

    def spec(name, x):
        if not isinstance(x, torch.Tensor) or x.ndim <= 1:
            return ()
        if name == "memory":                # whisper enc memory [B, T, d]
            return (ba if x.shape[0] % dp_size == 0 else None, None, None)
        if x.ndim == 2:                     # [L, B]-style
            return ((None, ba) if not shard_seq
                    and x.shape[1] % dp_size == 0 else ())
        if shard_seq:
            # [L, B=1, T, ...]: shard T over data+model; small states repl.
            if x.ndim >= 3 and x.shape[1] == 1 and x.shape[2] % \
                    (sizes["data"] * tp) == 0:
                return (None, None, ("data", "model"),
                        *([None] * (x.ndim - 3)))
            return ()
        b = ba if x.shape[1] % dp_size == 0 else None
        seq = "model" if x.ndim >= 5 and x.shape[2] % tp == 0 else None
        return (None, b, seq, *([None] * (x.ndim - 3)))

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else spec(k, v)
                for k, v in tree.items()}
    return walk(state)


def shard_bytes(shape, itemsize: int, spec: tuple, mesh) -> int:
    """Bytes of one device's shard of a leaf under ``spec`` (every sharded
    dim divides, as the rules check)."""
    sizes = axis_sizes(mesh)
    n = math.prod(int(s) for s in shape) * itemsize
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n //= sizes[a]
    return n


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)``
    on each mesh dim that names tensor dim ``d``, ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in axis_sizes(mesh):
        dim = None
        for d, entry in enumerate(spec):
            if axis == entry or (isinstance(entry, tuple) and axis in entry):
                dim = d
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)
