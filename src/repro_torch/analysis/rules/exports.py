"""Export-consistency rules (TEXP family).

Contract: the public surface of every ``repro_torch`` package is its
``__all__``, and lazy (PEP 562) re-exports stay in lockstep with it:
every ``__all__`` name binds at module top level, is served by
``__getattr__``'s table or is a submodule of the package (which ``from
pkg import *`` imports: ``kernels/__init__.py`` names its modules and
imports none), and every table name is in ``__all__``.
``__all__`` may be computed as literals, names of module-level literal
tables, ``*<table>`` inside a list, ``sorted()``/``list()``/``tuple()``
of a table and ``+`` (``repro_torch/__init__.py`` builds it from
``_PUBLIC``, ``launch/__init__.py`` from ``_HOME``).
"""
from __future__ import annotations

import ast

from ..framework import FileContext, Rule, register

_CONTRACT = "__all__ and the lazy-export table agree"
_ERRORS = (ValueError, TypeError, SyntaxError, MemoryError)


def _top_level_names(tree: ast.Module) -> set:
    names: set = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(stmt.name)
        elif isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    names |= {e.id for e in t.elts
                              if isinstance(e, ast.Name)}
        elif isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name):
            names.add(stmt.target.id)
        elif isinstance(stmt, ast.ImportFrom):
            names |= {a.asname or a.name for a in stmt.names}
        elif isinstance(stmt, ast.Import):
            names |= {(a.asname or a.name).split(".")[0]
                      for a in stmt.names}
    return names


def _const_env(tree: ast.Module) -> dict:
    """Module-level literal assignments."""
    env: dict = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            try:
                env[stmt.targets[0].id] = ast.literal_eval(stmt.value)
            except _ERRORS:
                pass
    return env


def _eval_all(node: ast.AST, env: dict):
    """An ``__all__`` expression's value, or None out of reach."""
    try:
        return list(ast.literal_eval(node))
    except _ERRORS:
        pass
    if isinstance(node, ast.Name):
        v = env.get(node.id)
        return list(v) if isinstance(v, (list, tuple, dict, set)) else None
    if isinstance(node, (ast.List, ast.Tuple)):        # with *starred
        out = []
        for e in node.elts:
            part = _eval_all(e.value, env) if isinstance(e, ast.Starred) \
                else _eval_all(ast.List([e]), env)
            if part is None:
                return None
            out += part
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left, right = _eval_all(node.left, env), _eval_all(node.right, env)
        return None if left is None or right is None else left + right
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("sorted", "list", "tuple") \
            and len(node.args) == 1:
        inner = _eval_all(node.args[0], env)
        return None if inner is None else (
            sorted(inner) if node.func.id == "sorted" else inner)
    return None


def _lazy_names(tree: ast.Module, env: dict) -> set:
    """Names ``__getattr__`` serves (``name in <table>`` tests in it)."""
    fn = next((s for s in tree.body if isinstance(s, ast.FunctionDef)
               and s.name == "__getattr__"), None)
    lazy: set = set()
    for node in ast.walk(fn) if fn is not None else ():
        if isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], ast.In):
            table = node.comparators[0]
            if isinstance(table, ast.Name):
                v = env.get(table.id)
            else:
                try:
                    v = ast.literal_eval(table)
                except _ERRORS:
                    v = None
            if isinstance(v, (dict, list, tuple, set, frozenset)):
                lazy |= set(v)
    return lazy


def _facts(ctx: FileContext):
    tree = ctx.tree
    assign = next((s for s in tree.body if isinstance(s, ast.Assign)
                   and any(isinstance(t, ast.Name) and t.id == "__all__"
                           for t in s.targets)), None)
    if assign is None:
        return None
    env = _const_env(tree)
    return (assign, _eval_all(assign.value, env), _top_level_names(tree),
            _lazy_names(tree, env))


class _ExportRule(Rule):
    contract = _CONTRACT

    def applies_to(self, rel: str) -> bool:
        return rel.startswith("src/repro_torch/") \
            and rel.endswith("__init__.py")


@register
class AllResolves(_ExportRule):
    id = "TEXP001"
    severity = "error"
    description = ("__all__ name with no top-level binding, no entry in "
                   "the lazy-export table and no submodule")

    def check_file(self, ctx: FileContext):
        facts = _facts(ctx)
        if facts is None:
            return
        assign, names, defined, lazy = facts
        if names is None:
            yield self.finding(
                ctx, assign, "__all__ is too dynamic for the linter; keep "
                "it literals, literal tables, sorted()/list() and +")
            return
        here = ctx.path.parent
        for name in names:
            submodule = (here / f"{name}.py").is_file() \
                or (here / name / "__init__.py").is_file()
            if name not in defined and name not in lazy and not submodule:
                yield self.finding(
                    ctx, assign, f"__all__ exports {name!r}, which the "
                    "module neither binds at top level nor serves from "
                    "__getattr__, and which is no submodule")


@register
class LazyAdvertised(_ExportRule):
    id = "TEXP002"
    severity = "error"
    description = "lazy-export table name missing from __all__"

    def check_file(self, ctx: FileContext):
        facts = _facts(ctx)
        if facts is None or facts[1] is None:
            return
        assign, names, _, lazy = facts
        for name in sorted(lazy - set(names)):
            yield self.finding(
                ctx, assign, f"__getattr__ serves {name!r}, which __all__ "
                "does not name; add it or drop it from the table")
