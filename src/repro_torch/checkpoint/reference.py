"""Numpy-only reader of the reference checkpoint format, and the functions
that carry the reference's DT and LM weights into the port, and an LM's
training state both ways.

A reference checkpoint (``repro.checkpoint.save_pytree``) is a directory
of ``leaf_<i>.npy`` files plus ``meta.json``: ``{"leaves": {path: {"file",
"shape", "dtype"}}, "digest": sha256}``, keyed by the pytree path joined
with ``/`` (``blocks/0/attn/q/w``).  The digest hashes, over the paths in
sorted order, each path and the first MiB of its array's bytes.

An LM training checkpoint (``repro.runtime.TrainLoop``'s) holds
``{"params", "opt": AdamWState(step, mu, nu), "step"}``, every block leaf
of ``params``, ``mu`` and ``nu`` stacked on a leading layer axis
(``params/blocks/attn/q/w`` [L, d, Hq*hd], ``opt/.mu/blocks/attn/q/w``);
:func:`lm_train_state_from_reference` and
:func:`lm_train_state_to_reference` convert it, so either package resumes
the other's run.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..configs import ArchConfig
from ..core.model import DT, DTConfig, param_tree
from ..optim import AdamWState
from .checkpointer import restore_pytree

__all__ = ["load_reference", "dt_params_from_reference",
           "lm_params_from_reference", "lm_train_state_from_reference",
           "lm_train_state_to_reference"]


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
    state = {_port_name(k): t for k, t in _unstack(flat, cfg).items()}
    model = model_cls(cfg, device="meta", dtype=torch.float32)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(dev).eval()


def _unstack(flat: dict, cfg: ArchConfig) -> dict[str, torch.Tensor]:
    """Reference leaves (stacked paths) -> f32 CPU tensors keyed by the
    per-layer paths of ``core.model.param_tree`` (``blocks/3/attn/q/w``);
    raises on a stacked leaf without the layer axis."""
    stacks = _stacks(cfg)
    out = {}
    for key, arr in flat.items():
        t = torch.as_tensor(np.asarray(arr, np.float32))
        group, _, rest = key.partition("/")
        if group in stacks and rest:
            L = stacks[group]
            if t.dim() == 0 or t.shape[0] != L:
                raise ValueError(f"{key}: leading axis {tuple(t.shape)[:1]} "
                                 f"is not the {L} layers")
            for i in range(L):
                out[f"{group}/{i}/{rest}"] = t[i]
        else:
            out[key] = t
    return out


def _stack(tree: dict, cfg: ArchConfig) -> dict[str, np.ndarray]:
    """The inverse of :func:`_unstack`: ``param_tree``-keyed tensors ->
    host f32 arrays under the reference's stacked paths."""
    stacks = _stacks(cfg)
    out, rows = {}, {}
    for key, t in tree.items():
        arr = t.detach().to("cpu", torch.float32, copy=True).numpy()
        group, _, rest = key.partition("/")
        if group in stacks and rest:
            i, _, leaf = rest.partition("/")
            rows.setdefault(f"{group}/{leaf}", {})[int(i)] = arr
        else:
            out[key] = arr
    for key, by_layer in rows.items():
        L = stacks[key.partition("/")[0]]
        if sorted(by_layer) != list(range(L)):
            raise ValueError(f"{key}: layers {sorted(by_layer)}, not the {L}")
        out[key] = np.stack([by_layer[i] for i in range(L)])
    return out


def _sub(flat: dict, prefix: str) -> dict:
    """The leaves of ``flat`` under ``prefix/``, keyed below it."""
    pre = f"{prefix}/"
    return {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}


def lm_train_state_from_reference(flat: dict[str, np.ndarray],
                                  cfg: ArchConfig, *, device=None):
    """``(model, AdamWState, step)`` from a reference LM training checkpoint
    (``flat``, as :func:`load_reference` returns it): the port's f32 LM
    for ``cfg`` (:func:`lm_params_from_reference` of ``params``), the
    optimizer state with ``mu``/``nu`` keyed as ``param_tree(model)`` on
    the model's device, and the last step the checkpoint completed.
    Raises on a missing, extra or misshapen leaf."""
    model = lm_params_from_reference(_sub(flat, "params"), cfg,
                                     device=device)
    keys = set(param_tree(model))
    dev = next(model.parameters()).device
    moments = []
    for name in (".mu", ".nu"):
        m = {k: t.to(dev) for k, t in _unstack(_sub(flat, f"opt/{name}"),
                                                cfg).items()}
        if set(m) != keys:
            raise KeyError(f"opt/{name} and params differ: "
                           f"{sorted(set(m) ^ keys)}")
        moments.append(m)
    known = {"step", "opt/.step"}
    extra = [k for k in flat if k not in known and not k.startswith(
        ("params/", "opt/.mu/", "opt/.nu/"))]
    if extra or not known <= set(flat):
        raise KeyError(f"not an LM training checkpoint: extra {extra}, "
                       f"missing {sorted(known - set(flat))}")
    opt = AdamWState(np.int32(flat["opt/.step"]), *moments)
    return model, opt, int(flat["step"])


def lm_train_state_to_reference(model, opt_state: AdamWState,
                                step: int, *, params=None) -> dict:
    """The reference's LM training state ``{"params", "opt", "step"}`` of
    the port's ``model`` and ``opt_state`` after ``step``: host arrays
    under the reference's stacked paths, ready for ``save_pytree`` or
    ``Checkpointer.save_async`` (the inverse of
    :func:`lm_train_state_from_reference`).  ``params`` (a
    ``param_tree``-keyed dict) stands in for the model's own tensors,
    e.g. a sharded model's leaves gathered whole."""
    cfg = model.cfg
    tree = param_tree(model) if params is None else params
    return {"params": _stack(tree, cfg),
            "opt": AdamWState(np.int32(opt_state.step),
                              _stack(opt_state.mu, cfg),
                              _stack(opt_state.nu, cfg)),
            "step": np.int64(step)}
