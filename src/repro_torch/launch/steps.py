"""Step builders shared by training, serving and the dry-run (port of
``repro.launch.steps``).

Each builder returns ``(step, abstract_args)``: ``abstract_args`` are a
``meta`` model and ``meta`` tensors (``models.registry.input_specs`` /
``decode_state_specs``) that allocate nothing, and ``step`` runs the cell
for real on a ``DeviceMesh`` whose 'model' axis is 1.

Placement (:meth:`Placement.place`): every block, and the model's
remaining leaves as the root, is wrapped by FSDP2 ``fully_shard`` over
the mesh's 'data' axis, each leaf stored sharded on the plan's FSDP dim
(``distributed.sharding.param_specs``; ``shard_placement_fn`` gives that
``Shard(dim)``, where FSDP2's default would take dim 0, which is not the
plan's for ``o/w`` and ``down/w``).  FSDP2 keeps no replicated parameter,
so a leaf the plan replicates (a norm's gain) is stored on dim 0.  The
batch is split over 'data' (each rank takes its contiguous rows and
returns its rows' results).  FSDP2 gathers a block's leaves into plain
tensors before the block runs, so the attention kernels, which take plain
tensors, never see a ``DTensor``.

The train step differentiates the family's ``loss_fn`` at ``impl=
"dense"`` (the reference's ``"xla"``) and ``remat="full"`` (the
reference's default: each block recomputed in the backward) and runs
AdamW (``default_tx``, no clipping inside) on each rank's local shards,
after clipping by the global norm summed over the ranks.  The loss runs
under ``mesh_ctx(mesh)``, so a MoE layer's load-balancing loss takes its
routed-slot shares over the global batch (``nn.moe``), as the
reference's step over the whole batch does.  Tensor parallelism (a
'model' axis above 1) is not carried yet: the builders raise
``NotImplementedError``, naming its ROADMAP item; the reference reaches
it only through GSPMD in its dry-run compile, which ``launch.dryrun``
accounts for analytically.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch import nn

from .. import optim
from ..configs import ArchConfig, Shape
from ..distributed.sharding import TP_ITEM, param_specs
from ..models import registry
from .mesh import axis_sizes

__all__ = ["abstract_model", "abstract_args", "build_train_step",
           "build_prefill", "build_decode_step", "default_tx", "Placement"]

_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def default_tx(lr: float = 3e-4):
    """AdamW of the reference's ``default_tx`` (weight decay 0.01) without
    the clip, which the sharded step applies over all ranks
    (``MAX_GRAD_NORM``)."""
    return optim.adamw(lr, weight_decay=0.01)


MAX_GRAD_NORM = 1.0


def abstract_model(cfg: ArchConfig, dtype=torch.bfloat16) -> nn.Module:
    """``cfg``'s model on the ``meta`` device (shapes and dtypes only)."""
    return registry.get_model(cfg).MODEL(cfg, device="meta", dtype=dtype)


def abstract_args(cfg: ArchConfig, shape: Shape, *, dtype=torch.bfloat16):
    """The cell's abstract arguments: ``(model, opt_state, batch)`` for a
    train shape, ``(model, batch)`` for prefill, ``(model, state, batch)``
    for decode; ``opt_state`` holds ``meta`` f32 AdamW moments."""
    model = abstract_model(cfg, dtype)
    batch = registry.input_specs(cfg, shape, act_dtype=dtype)
    if shape.kind == "train":
        from ..core.model import param_tree
        opt = default_tx().init(param_tree(model))
        return model, opt, batch
    if shape.kind == "prefill":
        return model, batch
    state = registry.decode_state_specs(cfg, shape, cache_dtype=dtype)
    return model, state, batch


class _Root(nn.Module):
    """The module FSDP2 roots at: its forward runs ``fn(model, *args)``,
    so the model's own leaves (embeddings, final norm, head) are gathered
    for the whole call."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


_ROOTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class Placement:
    """The cell's placement on a ``DeviceMesh`` with a 'data' axis and a
    'model' axis of 1: :meth:`place` shards a model by the plan (once: a
    model placed before, by another builder's step, is taken as it is),
    :meth:`share` takes this rank's rows of a batch."""

    def __init__(self, cfg: ArchConfig, mesh):
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"{type(mesh).__name__} has no devices: run a "
                            f"step on a DeviceMesh (launch.mesh.init_mesh); "
                            f"launch.dryrun prices a MeshSpec")
        sizes = axis_sizes(mesh)
        if sizes.get("model", 1) > 1:
            raise NotImplementedError(
                f"a 'model' axis of {sizes['model']}: {TP_ITEM}")
        if sizes.get("pod", 1) > 1:
            raise NotImplementedError(
                "a 'pod' axis above 1 (FSDP over two data axes) is not "
                "carried; run on a ('data', 'model') mesh")
        self.cfg, self.mesh = cfg, mesh
        self.dp = mesh["data"]
        self.group = self.dp.get_group()
        self.rank = self.dp.get_local_rank()
        self.n = self.dp.size()
        self.root = None

    def place(self, model: nn.Module) -> nn.Module:
        """Shard ``model`` in place by the plan (FSDP2 over 'data');
        returns it."""
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard
        from ..core.model import param_tree
        if getattr(model, "cfg", None) != self.cfg:
            raise ValueError(f"model of {getattr(model, 'cfg', None)}, the "
                             f"step is built for {self.cfg}")
        if model in _ROOTS:
            self.root = _ROOTS[model]
            return model
        specs = param_specs(model, self.mesh, self.cfg)
        dim_of = {}
        for k, p in param_tree(model).items():
            spec = specs[k]
            dim_of[id(p)] = next((d for d, e in enumerate(spec) if e ==
                                  "data" or (isinstance(e, tuple) and
                                             "data" in e)), 0)

        def placement(p):
            return Shard(dim_of[id(p)])
        kw = dict(mesh=self.dp, shard_placement_fn=placement)
        for name in _STACKS:
            for blk in getattr(model, name, ()):
                fully_shard(blk, **kw)
        self.root = _Root(model)
        fully_shard(self.root, **kw)
        _ROOTS[model] = self.root
        return model

    def share(self, batch: dict) -> dict:
        """This rank's contiguous rows of every leaf of ``batch``."""
        out = {}
        for k, v in batch.items():
            if v.shape[0] % self.n:
                raise ValueError(f"{k}: {v.shape[0]} rows do not divide "
                                 f"over {self.n} data ranks")
            m = v.shape[0] // self.n
            out[k] = v.narrow(0, self.rank * m, m)
        return out

    def run(self, fn, *args):
        if self.root is None:
            raise RuntimeError("place(model) first")
        return self.root(fn, *args)

    def local_tree(self, model) -> dict:
        """``param_tree`` of the placed model as this rank's local shards
        (views: writes reach the parameters)."""
        from ..core.model import param_tree
        return {k: p.to_local() if hasattr(p, "to_local") else p
                for k, p in param_tree(model).items()}

    def full_tree(self, model) -> dict:
        """``param_tree`` of the placed model gathered whole (a collective:
        every rank calls it)."""
        from ..core.model import param_tree
        return {k: p.full_tensor() if hasattr(p, "full_tensor") else p
                for k, p in param_tree(model).items()}


class TrainStep(Placement):
    """``step(model, opt_state, batch) -> (model, opt_state, loss)`` on a
    placed model; ``opt_state`` holds each rank's shards of the moments
    (:meth:`init_opt`); ``batch`` is the global batch, ``loss`` the global
    mean."""

    def __init__(self, cfg, mesh, *, impl, remat):
        super().__init__(cfg, mesh)
        self.loss = lambda model, b: registry.get_model(cfg).loss_fn(
            model, b, impl=impl, remat=remat)
        self.tx = default_tx()

    def init_opt(self, model):
        return self.tx.init(self.local_tree(model))

    def place(self, model, opt_state=None):
        """Shard ``model`` (and, given a whole ``opt_state`` keyed as its
        ``param_tree``, its moments to this rank's shards); returns the
        model, or ``(model, opt_state)``."""
        super().place(model)
        if opt_state is None:
            return model
        from ..core.model import param_tree
        dims = {k: p.placements[0].dim for k, p in param_tree(model).items()}
        cut = lambda tree: {k: self._chunk(t, dims[k]) for k, t in
                            tree.items()}
        return model, type(opt_state)(opt_state.step, cut(opt_state.mu),
                                      cut(opt_state.nu))

    def _chunk(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's FSDP2 shard of a whole tensor (``torch.chunk``
        semantics, as FSDP2 cuts)."""
        parts = torch.chunk(t, self.n, dim=dim)
        if self.rank < len(parts):
            return parts[self.rank].contiguous()
        shape = list(t.shape)
        shape[dim] = 0
        return t.new_zeros(shape)

    def gather_opt(self, model, opt_state):
        """The moments gathered whole (a collective: every rank calls
        it)."""
        import torch.distributed as dist
        from ..core.model import param_tree
        if self.n == 1:
            return opt_state
        ptree = param_tree(model)

        def whole(k, t):
            dim = ptree[k].placements[0].dim
            sizes = [c.shape[dim] for c in torch.chunk(
                torch.empty(ptree[k].shape, device="meta"), self.n, dim)]
            sizes += [0] * (self.n - len(sizes))
            pad = _with(t.shape, dim, max(sizes))
            mine = torch.zeros(pad, dtype=t.dtype, device=t.device)
            mine.narrow(dim, 0, t.shape[dim]).copy_(t)
            buf = [torch.empty_like(mine) for _ in range(self.n)]
            dist.all_gather(buf, mine, group=self.group)
            return torch.cat([b.narrow(dim, 0, m) for b, m in
                              zip(buf, sizes)], dim=dim)
        return type(opt_state)(
            opt_state.step, {k: whole(k, t) for k, t in opt_state.mu.items()},
            {k: whole(k, t) for k, t in opt_state.nu.items()})

    def __call__(self, model, opt_state, batch):
        import torch.distributed as dist
        from ..core.model import param_tree
        from .mesh import mesh_ctx
        if self.root is None or self.root.model is not model:
            raise RuntimeError("the step runs on the model it placed")
        with mesh_ctx(self.mesh):          # MoE: the global expert shares
            loss = self.run(self.loss, self.share(batch))
            loss.backward()
        loss = loss.detach()
        params = self.local_tree(model)
        grads = {}
        for k, p in param_tree(model).items():
            g = p.grad
            if g is None:                  # a leaf the loss does not reach
                g = torch.zeros_like(params[k])
            grads[k] = g.to_local() if hasattr(g, "to_local") else g
            p.grad = None
        keys = list(grads)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            [grads[k].float() for k in keys])))
        if self.n > 1:
            sq = norm * norm
            dist.all_reduce(sq, group=self.group)
            norm = torch.sqrt(sq)
        scale = torch.clamp_max(MAX_GRAD_NORM / (norm + 1e-9), 1.0)
        grads = dict(zip(keys, torch._foreach_mul(
            [grads[k] for k in keys], scale)))
        updates, opt_state = self.tx.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
        if self.n > 1:
            dist.all_reduce(loss, group=self.group)
            loss = loss / self.n
        return model, opt_state, loss


def _with(shape, dim, size):
    s = list(shape)
    s[dim] = size
    return s


def build_train_step(cfg: ArchConfig, shape: Shape, mesh, *,
                     impl: str = "dense", remat: str = "full",
                     dtype=torch.bfloat16):
    """``(TrainStep, (model, opt_state, batch) as meta)``.  Use:
    ``model = step.place(model)``, ``opt = step.init_opt(model)``, then
    ``model, opt, loss = step(model, opt, batch)``.  ``remat="full"`` (the
    reference's default) keeps each block's input and recomputes the
    block in the backward; ``"none"`` keeps every activation."""
    step = TrainStep(cfg, mesh, impl=impl, remat=remat)
    return step, abstract_args(cfg, shape, dtype=dtype)


class Prefill(Placement):
    """``prefill(model, batch) -> (last logits [b, 1, V], decode state)``
    of this rank's rows, the cache ``max_len`` long."""

    def __init__(self, cfg, mesh, *, impl, max_len, cache_dtype):
        super().__init__(cfg, mesh)
        mod = registry.get_model(cfg)
        self.fn = lambda model, b: mod.prefill(
            model, b, max_len, impl=impl, cache_dtype=cache_dtype)

    def __call__(self, model, batch):
        return self.run(self.fn, self.share(batch))


class DecodeStep(Placement):
    """``decode_step(model, state, batch) -> (next token [b, 1] int32,
    state)``: one token of this rank's rows, the state written in
    place."""

    def __init__(self, cfg, mesh, *, impl):
        super().__init__(cfg, mesh)
        mod = registry.get_model(cfg)

        def step(model, state, b):
            logits, state = mod.decode_step(model, state, b, impl=impl)
            nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            return nxt, state
        self.fn = step

    def __call__(self, model, state, batch):
        return self.run(self.fn, state, self.share(batch))


def build_prefill(cfg: ArchConfig, shape: Shape, mesh, *,
                  impl: str = "kernel", dtype=torch.bfloat16):
    """``(Prefill, (model, batch) as meta)``; the cache is
    ``registry.decode_cache_len(cfg, shape)`` long, in ``dtype``."""
    step = Prefill(cfg, mesh, impl=impl,
                   max_len=registry.decode_cache_len(cfg, shape),
                   cache_dtype=dtype)
    return step, abstract_args(cfg, _as_kind(shape, "prefill"), dtype=dtype)


def build_decode_step(cfg: ArchConfig, shape: Shape, mesh, *,
                      impl: str = "kernel", dtype=torch.bfloat16):
    """``(DecodeStep, (model, state, batch) as meta)``."""
    step = DecodeStep(cfg, mesh, impl=impl)
    return step, abstract_args(cfg, _as_kind(shape, "decode"), dtype=dtype)


def _as_kind(shape: Shape, kind: str) -> Shape:
    return shape if shape.kind == kind else dataclasses.replace(shape,
                                                                kind=kind)
