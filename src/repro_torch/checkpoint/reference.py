"""Numpy-only reader of the reference checkpoint format, and the functions
that carry the reference's DT and LM weights into the port.

A reference checkpoint (``repro.checkpoint.save_pytree``) is a directory
of ``leaf_<i>.npy`` files plus ``meta.json``: ``{"leaves": {path: {"file",
"shape", "dtype"}}, "digest": sha256}``, keyed by the pytree path joined
with ``/`` (``blocks/0/attn/q/w``).  The digest hashes, over the paths in
sorted order, each path and the first MiB of its array's bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..configs import ArchConfig
from ..core.model import DT, DTConfig
from .checkpointer import restore_pytree

__all__ = ["load_reference", "dt_params_from_reference",
           "lm_params_from_reference"]


def load_reference(path, *, verify: bool = True) -> dict[str, np.ndarray]:
    """``{path: ndarray}`` of a reference checkpoint directory; raises
    ``IOError`` when ``verify`` and the digest does not match."""
    return restore_pytree(path, verify=verify)


def _port_name(key: str) -> str:
    """Reference pytree path -> port ``state_dict`` key."""
    parts = key.split("/")
    if parts[0] == "type":
        parts[0] = "type_"
    return ".".join(parts)


def dt_params_from_reference(flat: dict[str, np.ndarray], *,
                             n_heads: int = DTConfig().n_heads,
                             device=None) -> DT:
    """Build the port's DT from the reference's DT parameters (``flat``, as
    :func:`load_reference` returns them).  The shapes fix every width but
    the head count, which is ``n_heads`` (the paper's 2 by default).
    Weights keep the reference layout (``x @ w``), so nothing is
    transposed.  Raises on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)
    n_blocks = len({k.split("/")[1] for k in flat if k.startswith("blocks/")})
    d_model = int(flat["emb_r/w"].shape[1])
    cfg = DTConfig(
        n_blocks=n_blocks, n_heads=n_heads, d_model=d_model,
        max_steps=int(flat["time/emb"].shape[0]),
        d_ff=int(flat["blocks/0/mlp/up/w"].shape[1]),
        hw_dim=int(flat["emb_h/w"].shape[0]) if "emb_h/w" in flat else 0)
    model = DT(cfg, generator=torch.Generator().manual_seed(0))
    state = {_port_name(k): torch.as_tensor(np.asarray(v, np.float32))
             for k, v in flat.items()}
    model.load_state_dict(state, strict=True)
    return model.to(dev).eval()


def _stacks(cfg: ArchConfig) -> dict[str, int]:
    """The reference's stacked block groups of ``cfg``'s model and their
    layer counts."""
    if cfg.family == "encdec":
        return {"enc_blocks": cfg.encoder_layers, "dec_blocks": cfg.n_layers}
    return {"blocks": cfg.n_layers}


def lm_params_from_reference(flat: dict[str, np.ndarray], cfg: ArchConfig,
                             *, device=None):
    """Build the port's LM for ``cfg``, in f32, from the reference LM's
    parameters (``flat``, as :func:`load_reference` returns them), for
    every family.  The model class is the ``MODEL`` of ``cfg``'s family in
    the registry (``models.lm.LM`` for the dense, MoE and VLM configs,
    ``rwkv_lm.RWKVLM``, ``hymba.Hymba``, ``encdec.EncDec``).  The
    reference stacks each block leaf on a leading layer axis
    (``blocks/attn/q/w`` is [L, d, Hq*hd]; whisper has ``enc_blocks`` and
    ``dec_blocks``); it is split into the per-layer
    ``blocks.<i>.attn.q.w``, and a nested leaf such as
    ``blocks/moe/router/w``, ``blocks/ssm/A_log`` or
    ``dec_blocks/xattn/q/w`` becomes ``blocks.<i>.moe.router.w`` and so
    on.  Raises on a missing, extra or misshapen leaf."""
    from ..models.registry import get_model
    model_cls = get_model(cfg).MODEL
    dev = resolve_device(device)
    stacks = _stacks(cfg)
    state = {}
    for key, arr in flat.items():
        t = torch.as_tensor(np.asarray(arr, np.float32))
        group, _, rest = key.partition("/")
        if group in stacks and rest:
            L = stacks[group]
            if t.dim() == 0 or t.shape[0] != L:
                raise ValueError(f"{key}: leading axis {tuple(t.shape)[:1]} "
                                 f"is not the {L} layers")
            rest = _port_name(rest)
            for i in range(L):
                state[f"{group}.{i}.{rest}"] = t[i]
        else:
            state[_port_name(key)] = t
    model = model_cls(cfg, device="meta", dtype=torch.float32)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(dev).eval()
