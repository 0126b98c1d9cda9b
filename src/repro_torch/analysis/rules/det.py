"""Determinism-hazard rules (TDET family).

Contract: the port's corpus and strategy cache are bit-reproducible, so
iteration feeding either has an explicit total order; the production
evaluators are f32 end to end (float64 is for the f64 oracles,
``core/ref_model.py`` and ``core/optimal.py``, which say so with a
suppression, as the reference's baseline entries do); and no trained path
accumulates with torch's nondeterministic scatters.  ``index_add_``,
``scatter_add_``, ``index_put_(..., accumulate=True)`` and
``F.embedding``'s backward add repeats with atomics on the card (and on 2+
CPU threads past 32768 elements), in another order from run to run: the
LM path gathers rows through ``nn.linear.take_rows``, whose backward is
``segment_sum`` (ROADMAP queue 3, PRs 17 and 22), so its one accumulating
``index_put_``, which adds exact zeros off the run ends, is the sanctioned
site.  An integer accumulation is exact in any order and takes a
suppression saying so.
"""
from __future__ import annotations

import ast

from ..framework import (FileContext, Rule, calls, dotted_name, method_name,
                         register)

_ORDER_SENSITIVE = {"src/repro_torch/core/dataset.py",
                    "src/repro_torch/serving/cache.py"}
_CORE = "src/repro_torch/core/"
_ACCUMULATE = {"index_add_", "index_add", "scatter_add_", "scatter_add"}
_EMBEDDING = {"F.embedding", "torch.nn.functional.embedding",
              "nn.functional.embedding", "functional.embedding"}


def _iters(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            yield node.iter
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            yield from (g.iter for g in node.generators)


@register
class SetIteration(Rule):
    id = "TDET001"
    severity = "error"
    description = ("iteration over a set in an order-sensitive module "
                   "(the corpus, the serialized strategy cache)")
    contract = "the port's corpus and cache are bit-reproducible"

    def applies_to(self, rel: str) -> bool:
        return rel in _ORDER_SENSITIVE

    def check_file(self, ctx: FileContext):
        for it in _iters(ctx.tree):
            if isinstance(it, (ast.Set, ast.SetComp)) or (
                    isinstance(it, ast.Call)
                    and dotted_name(it.func) in ("set", "frozenset")):
                yield self.finding(
                    ctx, it, "a set has no guaranteed order; iterate "
                    "sorted(...) so the bytes downstream are reproducible")


@register
class Float64InCore(Rule):
    id = "TDET002"
    severity = "warning"
    description = ("explicit float64 in src/repro_torch/core: the "
                   "evaluators are f32, f64 is for the oracles")
    contract = "f32 evaluators, f64 oracles"

    def applies_to(self, rel: str) -> bool:
        return rel.startswith(_CORE)

    def check_file(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Attribute)
                    and node.attr in ("float64", "double")) or (
                    isinstance(node, ast.Constant)
                    and node.value == "float64"):
                yield self.finding(
                    ctx, node, "float64 in core departs from the f32 "
                    "evaluators; only the f64 oracles use it, with a noqa "
                    "saying so")


@register
class NondeterministicAccumulate(Rule):
    id = "TDET003"
    severity = "error"
    description = ("index_add_/scatter_add_/index_put_(accumulate=True)/"
                   "F.embedding: accumulation in a run-dependent order")
    contract = "trained paths accumulate deterministically"

    def check_file(self, ctx: FileContext):
        for node in calls(ctx.tree):
            m = method_name(node)
            name = dotted_name(node.func)
            if m in _ACCUMULATE:
                what = f"{m}()"
            elif m in ("index_put_", "index_put") and any(
                    kw.arg == "accumulate" and not (
                        isinstance(kw.value, ast.Constant)
                        and not kw.value.value) for kw in node.keywords):
                what = f"{m}(..., accumulate=True)"
            elif name in _EMBEDDING:
                what = "F.embedding() (its backward)"
            else:
                continue
            yield self.finding(
                ctx, node, f"{what} adds repeats in a run-dependent order "
                "on the card; gather through nn.linear.take_rows (backward "
                "segment_sum), or suppress saying why the order cannot "
                "matter here")
