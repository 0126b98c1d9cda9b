"""Step builders shared by training, serving and the dry-run (port of
``repro.launch.steps``).

Each builder returns ``(step, abstract_args)``: ``abstract_args`` are a
``meta`` model and ``meta`` tensors (``models.registry.input_specs`` /
``decode_state_specs``) that allocate nothing, and ``step`` runs the cell
for real on a ``DeviceMesh`` of shape ``(data, model)`` or ``(pod, data,
model)``, any axis above 1.

Placement (:meth:`Placement.place`): first tensor parallelism, each leaf
cut to this rank's 'model' shard by the plan (``distributed.sharding.
param_specs`` of the global model; ``distributed.tp.shard_leaf``; a model
built sharded, ``init(shard=tp.Keep.of(...))``, is taken as it is); then
every block, and the model's remaining leaves as the root, is wrapped by
FSDP2 ``fully_shard`` over the data axes ('data', or ``("pod", "data")``
flattened), each leaf stored sharded on the plan's FSDP dim
(``shard_placement_fn`` gives that ``Shard(dim)``, where FSDP2's default
would take dim 0, which is not the plan's for ``o/w`` and ``down/w``).
FSDP2 keeps no replicated parameter, so a leaf the plan replicates (a
norm's gain) is stored on dim 0.  The batch is split over the data axes
(each rank takes its contiguous rows and returns its rows' results) and
whole on every rank of 'model'.  FSDP2 gathers a block's leaves into
plain tensors before the block runs, so the attention kernels, which take
plain tensors, never see a ``DTensor``, and the layers see their 'model'
shards as plain tensors (``distributed.tp``: every step runs under the
placement's ``tp.Parallel``).

A bf16 model keeps a few leaves in f32, as the reference does: the MoE
router ``router/w``, RWKV's ``w0`` and ``u``, the SSM's ``A_log`` and
``D``.  FSDP2 refuses a trainable group whose leaves have mixed types, so
a train placement passes every leaf of a type other than the model's
(:func:`_odd_leaves`) to ``fully_shard`` as ``ignored_params``: such a
leaf stays a whole, plain ``nn.Parameter`` on each rank, and the step
all-reduces its gradient over the data axes itself (one flat buffer a
type, averaged as FSDP2 averages) and counts it once in the clip's
global norm.  That is the plan's own placement for these leaves (it
replicates all five: ``moe/router/w`` and ``ssm/`` rule ``(None,
None)``, ``w0`` and ``u`` match no rule), and the one that
``cost_analysis.collective_bytes`` prices for a replicated leaf (an
all-reduce of its gradient), so the payload model needs no change; the
router could have taken an FSDP2 group of its own, but then ``w0``,
``u``, ``A_log`` and ``D``, direct leaves of modules that hold bf16
leaves, would still need this route, and one route is simpler than two.
An f32 model has no such leaf and runs as before.  A placement for
inference (prefill, decode, scoring) freezes the leaves it wraps
(``requires_grad`` off), which FSDP2 also takes.

The train step differentiates the family's ``loss_fn`` at ``impl=
"dense"`` (the reference's ``"xla"``) and ``remat="full"`` (the
reference's default: each block recomputed in the backward; ``"dots"``
keeps the unbatched products' outputs, ``"none"`` everything) and runs
AdamW (``default_tx``, no clipping inside) on each rank's local shards,
after clipping by the global norm summed over the ranks.  The loss runs
under the placement's ``tp.Parallel``, so a MoE layer's load-balancing
loss takes its routed-slot shares over the global batch (``nn.moe``), as
the reference's step over the whole batch does.  The clip's global norm
sums each leaf once: a leaf sharded over 'model' over both axes, a leaf
replicated over 'model' over the data axes only.

The decode state (prefill and decode) is placed by
``decode_state_specs_sharded``: its batch over the data axes, a cache's
sequence over 'model' (``Parallel.seq``; whole where the cache length
does not divide), and a global batch of 1 whole on every rank with the
sequence over ``("data", "model")`` flattened (the plan's SP form).  The
decode step's argmax runs over the all-gathered logits row, so it is
``torch.argmax``'s over the whole vocabulary.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import optim
from ..configs import ArchConfig, Shape
from ..distributed import tp
from ..distributed.sharding import param_specs
from ..models import registry
from .mesh import dp_axes, submesh

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


def _odd_leaves(tree: dict) -> set:
    """The keys of a ``param_tree``-keyed dict whose leaves have a type
    other than the model's (its most common leaf type): a bf16 model's
    f32 router, RWKV decay and SSM state; none in an f32 model."""
    from collections import Counter
    main = Counter(t.dtype for t in tree.values()).most_common(1)[0][0]
    return {k for k, t in tree.items() if t.dtype != main}


class _Root(nn.Module):
    """The module FSDP2 roots at: its forward runs ``fn(model, *args)``,
    so the model's own leaves (embeddings, final norm, head) are gathered
    for the whole call."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


_ROOT = "_placement_root"      # the attribute a placed model keeps its root in


class Placement:
    """The cell's placement on a ``DeviceMesh`` with a 'data' axis (and a
    'pod' axis) and a 'model' axis: :meth:`place` shards a model by the
    plan (once: a model placed before, by another builder's step, is
    taken as it is), :meth:`share` takes this rank's rows of a batch,
    :meth:`run` runs under the placement's ``tp.Parallel``.  ``trains``:
    whether the leaves keep their gradients (else they are frozen at
    :meth:`place`, and a train step refuses the model)."""

    trains = False

    def __init__(self, cfg: ArchConfig, mesh):
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"{type(mesh).__name__} has no devices: run a "
                            f"step on a DeviceMesh (launch.mesh.init_mesh); "
                            f"launch.dryrun prices a MeshSpec")
        self.cfg, self.mesh = cfg, mesh
        self.dp = submesh(mesh, dp_axes(mesh))
        self.group = self.dp.get_group()
        self.rank = self.dp.get_local_rank()
        self.n = self.dp.size()
        model = mesh["model"]
        self.tp = tp.Axis(model.get_group(), model.get_local_rank(),
                          model.size())
        self.par = tp.Parallel(self.tp, tp.Axis(self.group, self.rank,
                                                self.n))
        self.specs = param_specs(abstract_model(cfg), mesh, cfg)
        self.root = None
        self.whole = set()    # leaves FSDP2 ignores: whole on every rank

    def place(self, model: nn.Module) -> nn.Module:
        """Shard ``model`` in place by the plan (its 'model' shard, then
        FSDP2 over the data axes); returns it."""
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard
        from ..core.model import param_tree
        if getattr(model, "cfg", None) != self.cfg:
            raise ValueError(f"model of {getattr(model, 'cfg', None)}, the "
                             f"step is built for {self.cfg}")
        if self.trains:
            self.whole = _odd_leaves(param_tree(model))
            if any(self.model_sharded(k) for k in self.whole):
                raise ValueError(f"{sorted(self.whole)}: a leaf of another "
                                 f"type than the model's must be whole over "
                                 f"'model' (the plan replicates them)")
        if _ROOT in model.__dict__:
            if self.trains and not all(p.requires_grad
                                       for p in model.parameters()):
                raise ValueError("the model was placed for inference (its "
                                 "leaves frozen): a train step places a "
                                 "model of its own")
            self.root = model.__dict__[_ROOT]
            return model
        self._cut(model)
        if not self.trains:
            model.requires_grad_(False)
        ignored = {p for k, p in param_tree(model).items() if k in self.whole}
        dim_of = {}
        for k, p in param_tree(model).items():
            spec = self.specs[k]
            dim_of[id(p)] = next((d for d, e in enumerate(spec) if e ==
                                  "data" or (isinstance(e, tuple) and
                                             "data" in e)), 0)

        def placement(p):
            return Shard(dim_of[id(p)])
        kw = dict(mesh=self.dp, shard_placement_fn=placement)
        for name in _STACKS:
            for blk in getattr(model, name, ()):
                fully_shard(blk, ignored_params=ignored & set(
                    blk.parameters()) or None, **kw)
        self.root = _Root(model)
        fully_shard(self.root, ignored_params=ignored or None, **kw)
        # a plain attribute, not a submodule: the model and its root live
        # and die together (a table keyed by the model would keep it)
        model.__dict__[_ROOT] = self.root
        return model

    def _cut(self, model: nn.Module) -> None:
        """Each leaf of a whole model to this rank's 'model' shard; a leaf
        already at its shard's shape (a model built sharded) stays."""
        from ..core.model import param_tree
        meta = param_tree(abstract_model(self.cfg))
        whole = []
        for k, p in param_tree(model).items():
            cut = tp.shard_leaf(meta[k], self.specs[k], self.tp.rank,
                                self.tp.size).shape
            if p.shape == meta[k].shape and cut != p.shape:
                whole.append(k)
            elif p.shape != cut:
                raise ValueError(f"{k}: shape {tuple(p.shape)} is neither "
                                 f"the whole leaf's {tuple(meta[k].shape)} "
                                 f"nor its 'model' shard's {tuple(cut)}")
        if whole:
            tp.shard_module(model, {k: self.specs[k] for k in whole} |
                            {k: () for k in self.specs if k not in whole},
                            self.tp.rank, self.tp.size)

    def share(self, batch: dict) -> dict:
        """This rank's contiguous rows of every leaf of ``batch``; a batch
        of one row is whole on every rank (the SP form)."""
        out = {}
        for k, v in batch.items():
            if v.shape[0] == 1 and self.n > 1:
                out[k] = v
                continue
            if v.shape[0] % self.n:
                raise ValueError(f"{k}: {v.shape[0]} rows do not divide "
                                 f"over {self.n} data ranks")
            m = v.shape[0] // self.n
            out[k] = v.narrow(0, self.rank * m, m)
        return out

    def run(self, fn, *args):
        if self.root is None:
            raise RuntimeError("place(model) first")
        with tp.parallel(self.par):
            return self.root(fn, *args)

    def model_sharded(self, key: str) -> bool:
        """Whether the plan shards leaf ``key`` over 'model' (above 1)."""
        return self.tp.size > 1 and tp.model_dim(self.specs[key]) is not None

    def _tp_whole(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """A leaf's 'model' shards gathered whole (a collective over
        'model')."""
        if not self.model_sharded(key):
            return t
        import torch.distributed as dist
        buf = [torch.empty_like(t) for _ in range(self.tp.size)]
        dist.all_gather(buf, t.contiguous(), group=self.tp.group)
        return torch.cat(buf, dim=tp.model_dim(self.specs[key]))

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
        return {k: self._tp_whole(k, p.full_tensor() if hasattr(
            p, "full_tensor") else p) for k, p in param_tree(model).items()}

    def _seq(self, batch: dict, max_len: int):
        """The axis the decode cache's sequence is cut over for ``batch``:
        'model', or ``("data", "model")`` for a batch of one row on
        several data ranks; None where ``max_len`` does not divide (the
        plan keeps the cache whole)."""
        B = next(iter(batch.values())).shape[0]
        ax = self.tp
        if B == 1 and self.n > 1:
            m = submesh(self.mesh, ("data", "model"))
            ax = tp.Axis(m.get_group(), m.get_local_rank(), m.size())
        return ax if ax.size > 1 and max_len % ax.size == 0 else None


class TrainStep(Placement):
    """``step(model, opt_state, batch) -> (model, opt_state, loss)`` on a
    placed model; ``opt_state`` holds each rank's shards of the moments
    (:meth:`init_opt`); ``batch`` is the global batch, ``loss`` the global
    mean."""

    trains = True

    def __init__(self, cfg, mesh, *, impl, remat):
        super().__init__(cfg, mesh)
        self.loss = lambda model, b: registry.get_model(cfg).loss_fn(
            model, b, impl=impl, remat=remat)
        self.tx = default_tx()

    def init_opt(self, model):
        return self.tx.init(self.local_tree(model))

    def place(self, model, opt_state=None):
        """Shard ``model`` (and, given a whole ``opt_state`` keyed as its
        ``param_tree``, its moments to this rank's shards, 'model' then
        data); returns the model, or ``(model, opt_state)``."""
        super().place(model)
        if opt_state is None:
            return model
        from ..core.model import param_tree
        dims = {k: p.placements[0].dim for k, p in param_tree(model).items()
                if k not in self.whole}
        cut = lambda tree: {k: self._chunk(tp.shard_leaf(
            t, self.specs[k], self.tp.rank, self.tp.size), dims.get(k))
            for k, t in tree.items()}
        return model, type(opt_state)(opt_state.step, cut(opt_state.mu),
                                      cut(opt_state.nu))

    def _chunk(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's FSDP2 shard of a whole tensor (``torch.chunk``
        semantics, as FSDP2 cuts); ``dim`` None: a leaf FSDP2 ignores,
        whole."""
        if dim is None:
            return t
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
        ptree = param_tree(model)

        def whole(k, t):
            if self.n == 1 or k in self.whole:
                return t
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
            opt_state.step,
            {k: self._tp_whole(k, whole(k, t)) for k, t in
             opt_state.mu.items()},
            {k: self._tp_whole(k, whole(k, t)) for k, t in
             opt_state.nu.items()})

    def __call__(self, model, opt_state, batch):
        import torch.distributed as dist
        from ..core.model import param_tree
        if self.root is None or self.root.model is not model:
            raise RuntimeError("the step runs on the model it placed")
        loss = self.run(self.loss, self.share(batch))
        with tp.parallel(self.par):        # the backward's collectives
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
        if self.whole and self.n > 1:
            self._all_reduce_whole(grads)
        if self.tp.size == 1 and not (self.whole and self.n > 1):
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
                [grads[k].float() for k in keys])))
            if self.n > 1:
                sq = norm * norm
                dist.all_reduce(sq, group=self.group)
                norm = torch.sqrt(sq)
        else:                              # each leaf once over the ranks
            sq = [torch.zeros((), device=loss.device) for _ in range(3)]
            for i, part in enumerate((
                    [k for k in keys if self.model_sharded(k)],
                    [k for k in keys if not self.model_sharded(k)
                     and k not in self.whole],
                    [k for k in keys if k in self.whole])):
                if part:
                    sq[i] = torch.square(torch.linalg.vector_norm(
                        torch.stack(torch._foreach_norm(
                            [grads[k].float() for k in part]))))
            if self.tp.size > 1:
                dist.all_reduce(sq[0], group=self.tp.group)
            tot = sq[0] + sq[1]
            if self.n > 1:
                dist.all_reduce(tot, group=self.group)
            norm = torch.sqrt(tot + sq[2]) if self.whole else torch.sqrt(tot)
        scale = torch.clamp_max(MAX_GRAD_NORM / (norm + 1e-9), 1.0)
        grads = dict(zip(keys, torch._foreach_mul(
            [grads[k] for k in keys], scale)))
        updates, opt_state = self.tx.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
        if self.n > 1:
            dist.all_reduce(loss, group=self.group)
            loss = loss / self.n
        return model, opt_state, loss


    def _all_reduce_whole(self, grads: dict) -> None:
        """The mean over the data ranks of the gradients of the leaves
        FSDP2 ignores (:attr:`whole`), one flat all-reduce a type, copied
        back into each gradient's own storage."""
        import torch.distributed as dist
        by_type = {}
        for k in grads:
            if k in self.whole:
                by_type.setdefault(grads[k].dtype, []).append(k)
        for ks in by_type.values():
            flat = torch.cat([grads[k].reshape(-1) for k in ks])
            dist.all_reduce(flat, group=self.group)
            flat /= self.n
            for k, g in zip(ks, flat.split([grads[k].numel() for k in ks])):
                grads[k].copy_(g.view_as(grads[k]))


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
    block in the backward; ``"dots"`` also keeps the outputs of its
    unbatched products (``nn.transformer.remat_call``); ``"none"`` keeps
    every activation."""
    step = TrainStep(cfg, mesh, impl=impl, remat=remat)
    return step, abstract_args(cfg, shape, dtype=dtype)


class Prefill(Placement):
    """``prefill(model, batch) -> (last logits [b, 1, V], decode state)``
    of this rank's rows, the cache ``max_len`` long (this rank's share of
    it, ``Placement._seq``)."""

    def __init__(self, cfg, mesh, *, impl, max_len, cache_dtype):
        super().__init__(cfg, mesh)
        mod = registry.get_model(cfg)
        self.max_len = max_len
        self.fn = lambda model, b: mod.prefill(
            model, b, max_len, impl=impl, cache_dtype=cache_dtype)

    def __call__(self, model, batch):
        self.par.seq = self._seq(batch, self.max_len)
        return self.run(self.fn, self.share(batch))


class DecodeStep(Placement):
    """``decode_step(model, state, batch) -> (next token [b, 1] int32,
    state)``: one token of this rank's rows, the state written in
    place; ``max_len`` the cache length its prefill was built with."""

    def __init__(self, cfg, mesh, *, impl, max_len):
        super().__init__(cfg, mesh)
        mod = registry.get_model(cfg)
        self.max_len = max_len

        def step(model, state, b):
            logits, state = mod.decode_step(model, state, b, impl=impl)
            return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32), \
                state
        self.fn = step

    def __call__(self, model, state, batch):
        self.par.seq = self._seq(batch, self.max_len)
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
    """``(DecodeStep, (model, state, batch) as meta)``; the state is one
    of :func:`build_prefill` at the same ``shape``."""
    step = DecodeStep(cfg, mesh, impl=impl,
                      max_len=registry.decode_cache_len(cfg, shape))
    return step, abstract_args(cfg, _as_kind(shape, "decode"), dtype=dtype)


def _as_kind(shape: Shape, kind: str) -> Shape:
    return shape if shape.kind == kind else dataclasses.replace(shape,
                                                                kind=kind)
