"""Condition-keyed cache rule (TJIT family), the port's counterpart of
the reference's JIT rules.

The port has no jit site, but its contract is the same: the serving
conditions (hardware, workload) are data, never compile-time constants
(the reference's PR 5 bug: a kernel specialised on the accelerator, one
build a condition and a wrong answer for a mismatched one).  In the port
the compile-time constants are the per-signature caches around its kernel
builds and launch plans: a ``functools.lru_cache`` / ``functools.cache``
function in ``src/repro_torch/`` may not take a condition-named parameter
(the reference's ``_CONDITION_TOKENS``).  A cache that keys something
other than a build (the serving engine's strategy-cache key) takes a
justified suppression.  The reference's JIT002 (an empty static set at a
jit site) has no counterpart.
"""
from __future__ import annotations

import ast
import re

from ..framework import FileContext, Rule, dotted_name, register

_CONDITION_TOKENS = {"hw", "hwvec", "accel", "accelerator", "workload",
                     "wl", "wls", "net", "network", "arch"}
_SPLIT = re.compile(r"[_\d]+")
_CACHES = {"lru_cache", "cache"}


def is_condition_name(name: str) -> bool:
    return any(tok in _CONDITION_TOKENS
               for tok in _SPLIT.split(name.lower()) if tok)


def _cached(fn) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name.rsplit(".", 1)[-1] in _CACHES and name in (
                "lru_cache", "cache", "functools.lru_cache",
                "functools.cache"):
            return True
    return False


@register
class ConditionKeyedCache(Rule):
    id = "TJIT001"
    severity = "error"
    description = ("functools.lru_cache/cache function taking a "
                   "hardware/workload-like parameter: a condition as a "
                   "compile-time key")
    contract = "conditions are data, never compile-time constants"

    def applies_to(self, rel: str) -> bool:
        return rel.startswith("src/repro_torch/") and rel.endswith(".py")

    def check_file(self, ctx: FileContext):
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or not _cached(fn):
                continue
            a = fn.args
            for p in a.posonlyargs + a.args + a.kwonlyargs:
                if is_condition_name(p.arg):
                    yield self.finding(
                        ctx, fn, f"{fn.name}() is cached on parameter "
                        f"{p.arg!r}, a hardware/workload condition: one "
                        "build or plan a condition; pass the condition as "
                        "data")
