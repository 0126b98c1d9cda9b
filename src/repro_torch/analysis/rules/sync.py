"""Host-device sync rules (TSYNC family).

Contract: the fused mapper episode makes no host sync -- no ``.item()``
and no Python branch on a device tensor (``core/infer.py``'s docstring);
so is every function it calls a step, which is what lets the episode be
captured whole (a CUDA graph) and lets a served row's answer be the same
in any batch.  The serving hot path (``src/repro_torch/serving/``)
additionally treats ``.item()`` and ``float()/int()/bool()`` of a torch
expression as a hidden per-request sync, as the reference's SYNC rules
treat their own.

The device-only functions (:data:`DEVICE_ONLY`, the counterpart of the
reference's jitted bodies) are named here, by file and qualified name:
``_fused_episode`` and ``_guard``; the ``core/env.py`` functions the
episode calls a step; the DT's decode path in ``core/model.py`` (its
backend's ``prefill``/``step``/``state_init``: ``core/backend.py`` holds
only the protocol and the registry, and ``backend_for`` runs once an
episode, on the host); and the prefix carry in ``core/cost_model.py``
that ``env_step``, ``env_observe`` and the guard run.  In them TSYNC003
flags ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
``torch.cuda.synchronize()`` and ``float()/int()/bool()`` of anything but
a literal, a host-annotated parameter, an UPPER_CASE constant or a shape;
TSYNC004 flags an ``if``/``while``/``assert``/conditional expression
whose test reads a parameter not annotated as a host type (``int``,
``bool``, ``float``, ``str``), or calls into torch, outside ``is None``,
``isinstance()``, ``hasattr()``, ``callable()`` and ``len()``.

The serving engine's intended host copies (``serving/engine.py``: the
checkpoint fingerprint's and ``_host``'s one ``.cpu()`` of an episode's
results) fall outside TSYNC001/TSYNC002 by scope: those rules, as the
reference's serving half, look at ``.item()`` and scalarization only.
"""
from __future__ import annotations

import ast

from ..framework import (FileContext, Rule, calls, dotted_name, functions,
                         method_name, register)

_CONTRACT = "the fused episode and the serving hot path make no host sync"
_SERVING = "src/repro_torch/serving/"

DEVICE_ONLY = {
    "src/repro_torch/core/infer.py": {"_fused_episode", "_guard"},
    "src/repro_torch/core/env.py": {
        "encode_action", "decode_action", "returns_to_go", "_shape_feats",
        "_budget_feat", "env_make", "env_reset", "env_observe", "env_step",
        "env_final"},
    "src/repro_torch/core/model.py": {
        "DT.hw_emb", "DT.time_at", "DT.time_emb", "dt_cache_init",
        "_blocks_cached", "dt_prefill", "dt_decode_step",
        "DTBackend.state_init", "DTBackend.prefill", "DTBackend.step"},
    "src/repro_torch/core/cost_model.py": {
        "_col", "_at", "_hw_terms", "_util", "_select", "_terms",
        "_same_group", "_close_terms", "prefix_init", "prefix_step",
        "prefix_out", "prefix_probe_peak"},
}

_HOST_METHODS = {"item", "cpu", "tolist", "numpy"}
_HOST_TYPES = {"int", "bool", "float", "str"}
_STRUCTURAL = {"isinstance", "hasattr", "callable", "len"}


def _torch_rooted(node: ast.AST) -> bool:
    return any(isinstance(s, ast.Name) and s.id == "torch"
               for s in ast.walk(node))


def _scalar_call(node: ast.Call) -> bool:
    return isinstance(node.func, ast.Name) \
        and node.func.id in ("float", "int", "bool") and len(node.args) == 1


def _host_value(node: ast.AST, host: set) -> bool:
    """A literal, a parameter in ``host``, an UPPER_CASE constant or a
    shape: host data."""
    if isinstance(node, ast.Constant) or (isinstance(node, ast.Name)
                                          and node.id in host):
        return True
    name = dotted_name(node)
    if name and name.rsplit(".", 1)[-1].isupper():
        return True
    return any(isinstance(s, ast.Attribute) and s.attr in ("shape", "ndim")
               for s in ast.walk(node))


def _params(fn) -> tuple[set, set]:
    """``(device, host)`` parameters of ``fn``: host are ``self``, ``cls``
    and those annotated as a host type; the rest may hold tensors."""
    a = fn.args
    device, host = set(), set()
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        ann = dotted_name(p.annotation) if p.annotation is not None else ""
        is_host = p.arg in ("self", "cls") or ann in _HOST_TYPES
        (host if is_host else device).add(p.arg)
    return device, host


def _read_names(test: ast.AST) -> set:
    """Names ``test`` reads, but for the operands of ``is None`` /
    ``is not None`` and the arguments of the structural calls."""
    skip = set()
    for s in ast.walk(test):
        if isinstance(s, ast.Compare) \
                and all(isinstance(op, (ast.Is, ast.IsNot)) for op in s.ops) \
                and all(isinstance(c, ast.Constant) and c.value is None
                        for c in s.comparators):
            skip |= {id(n) for o in [s.left] + s.comparators
                     for n in ast.walk(o)}
        elif isinstance(s, ast.Call) and isinstance(s.func, ast.Name) \
                and s.func.id in _STRUCTURAL:
            skip |= {id(n) for n in ast.walk(s)}
    return {s.id for s in ast.walk(test)
            if isinstance(s, ast.Name) and id(s) not in skip}


def device_functions(ctx: FileContext):
    """``(qualified name, def)`` of the file's device-only functions."""
    names = DEVICE_ONLY.get(ctx.rel, ())
    return [(q, f) for q, f in functions(ctx.tree) if q in names]


@register
class ItemInServing(Rule):
    id = "TSYNC001"
    severity = "error"
    description = ".item() in the serving hot path (a per-request sync)"
    contract = _CONTRACT

    def applies_to(self, rel: str) -> bool:
        return rel.startswith(_SERVING)

    def check_file(self, ctx: FileContext):
        for node in calls(ctx.tree):
            if method_name(node) == "item" and not node.args:
                yield self.finding(
                    ctx, node, ".item() in the serving hot path; keep "
                    "scalars on the device or copy an episode's results "
                    "to the host once")


@register
class ScalarizeInServing(Rule):
    id = "TSYNC002"
    severity = "warning"
    description = ("float()/int()/bool() of a torch expression in the "
                   "serving hot path (a device sync)")
    contract = _CONTRACT

    def applies_to(self, rel: str) -> bool:
        return rel.startswith(_SERVING)

    def check_file(self, ctx: FileContext):
        for node in calls(ctx.tree):
            if _scalar_call(node) and _torch_rooted(node.args[0]):
                yield self.finding(
                    ctx, node, f"{node.func.id}() of a torch expression in "
                    "the serving hot path forces a host round trip")


@register
class HostMaterializeOnDevicePath(Rule):
    id = "TSYNC003"
    severity = "error"
    description = (".item()/.cpu()/.tolist()/.numpy()/torch.cuda."
                   "synchronize()/float()/int()/bool() of a tensor in a "
                   "device-only function")
    contract = _CONTRACT

    def applies_to(self, rel: str) -> bool:
        return rel in DEVICE_ONLY

    def check_file(self, ctx: FileContext):
        for q, fn in device_functions(ctx):
            host = _params(fn)[1]
            for node in calls(fn):
                m = method_name(node)
                if m in _HOST_METHODS and not node.args:
                    what = f".{m}()"
                elif dotted_name(node.func) == "torch.cuda.synchronize":
                    what = "torch.cuda.synchronize()"
                elif _scalar_call(node) \
                        and not _host_value(node.args[0], host):
                    what = f"{node.func.id}() of a tensor"
                else:
                    continue
                yield self.finding(
                    ctx, node, f"{what} in {q}, a device-only function "
                    "(the fused episode's step): a host sync")


@register
class BranchOnTensor(Rule):
    id = "TSYNC004"
    severity = "error"
    description = ("if/while/assert test on a tensor in a device-only "
                   "function (a host sync, and a data-dependent path)")
    contract = _CONTRACT

    def applies_to(self, rel: str) -> bool:
        return rel in DEVICE_ONLY

    def check_file(self, ctx: FileContext):
        for q, fn in device_functions(ctx):
            params = _params(fn)[0]
            for node in ast.walk(fn):
                if isinstance(node, (ast.If, ast.While, ast.IfExp,
                                     ast.Assert)):
                    read = sorted(_read_names(node.test) & params)
                    if read or any(_torch_rooted(c.func) or method_name(c)
                                   in ("any", "all") for c in
                                   calls(node.test)):
                        yield self.finding(
                            ctx, node.test, f"a Python branch on "
                            f"{read or 'a torch value'} in {q}, a "
                            "device-only function: use torch.where")
