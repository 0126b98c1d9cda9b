"""Rule framework of the port's contract linter (the port's copy of
``repro.analysis.framework``).

A :class:`Rule` is a named, severity-tagged check over one parsed file
(:meth:`Rule.check_file`) or over the file set as a whole
(:meth:`Rule.check_repo`).  Rules register into :data:`RULES` by
:func:`register`; the :class:`Analyzer` walks the file set once, parses
each file once, runs every rule, applies the in-source ``# repro_torch:
noqa[ID] -- why`` suppressions, and reports the TANA meta-findings (bare
or dead suppressions) itself.

The reference's shared ``jax.jit`` site model has no counterpart: the
port has no jit site (``rules/jit.py`` says what takes its place).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Iterable, Iterator

from .findings import (Finding, RULE_ID_RE, Severity, Suppression,
                       parse_suppressions)

RULES: dict[str, "Rule"] = {}


def register(rule_cls):
    """Class decorator: instantiate the rule and add it to the registry."""
    rule = rule_cls()
    if not RULE_ID_RE.match(rule.id):
        raise ValueError(f"bad rule id {rule.id!r}")
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    RULES[rule.id] = rule
    return rule_cls


@dataclasses.dataclass
class FileContext:
    """One analyzed file: source, parsed tree and suppression table."""
    root: pathlib.Path
    path: pathlib.Path             # absolute
    rel: str                       # repo-relative posix path
    source: str
    lines: list[str]
    tree: ast.AST | None           # None when the file failed to parse
    suppressions: dict[int, Suppression]

    @classmethod
    def load(cls, root: pathlib.Path, path: pathlib.Path) -> "FileContext":
        source = path.read_text()
        try:
            tree = ast.parse(source, filename=str(path))
        except SyntaxError:
            tree = None
        return cls(root, path, path.relative_to(root).as_posix(), source,
                   source.splitlines(), tree, parse_suppressions(source))

    def line_text(self, line: int) -> str:
        return self.lines[line - 1].strip() if 1 <= line <= len(self.lines) \
            else ""


class Rule:
    """Base rule.  Subclasses set ``id``, ``severity``, ``description``
    and ``contract`` (the port's contract the rule mechanizes), then
    override one of the two check hooks."""
    id = "XXX000"
    severity = Severity.ERROR
    description = ""
    contract = ""

    def applies_to(self, rel: str) -> bool:
        return rel.endswith(".py")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def check_repo(self, root: pathlib.Path,
                   ctxs: list[FileContext]) -> Iterable[Finding]:
        return ()

    def finding(self, ctx: FileContext, node_or_line, message: str,
                col: int | None = None) -> Finding:
        if isinstance(node_or_line, int):
            line, c = node_or_line, col or 0
        else:
            line, c = node_or_line.lineno, node_or_line.col_offset
        return Finding(self.id, ctx.rel, line, c, message, self.severity,
                       ctx.line_text(line))


def dotted_name(node: ast.AST) -> str:
    """The dotted name of a Name/Attribute chain ('' otherwise)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def calls(tree: ast.AST) -> Iterator[ast.Call]:
    """Every call in ``tree``."""
    return (n for n in ast.walk(tree) if isinstance(n, ast.Call))


def method_name(call: ast.Call) -> str | None:
    """``m`` for a call ``<anything>.m(...)``, else None."""
    return call.func.attr if isinstance(call.func, ast.Attribute) else None


def functions(tree: ast.AST) -> Iterator[tuple[str, ast.AST]]:
    """``(qualified name, def)`` of every function: ``f`` at module level,
    ``Cls.m`` for a method, ``f.<locals>.g`` for a nested one."""
    def walk(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = prefix + node.name
                yield name, node
                yield from walk(node.body, name + ".<locals>.")
            elif isinstance(node, ast.ClassDef):
                yield from walk(node.body, prefix + node.name + ".")
    yield from walk(getattr(tree, "body", []), "")


# ------------------------------------------------------------------ analyzer

DEFAULT_GLOBS = ("src/repro_torch/**/*.py", "examples/*_torch.py",
                 "chip_smoke.py")


def default_files(root: pathlib.Path) -> list[pathlib.Path]:
    """The port's file set under ``root``."""
    out: list[pathlib.Path] = []
    for g in DEFAULT_GLOBS:
        out += sorted(root.glob(g))
    return out


@dataclasses.dataclass
class AnalysisResult:
    findings: list[Finding]        # active (unsuppressed) findings
    suppressed: list[Finding]      # findings absorbed by a valid noqa
    files: list[str]               # repo-relative paths analyzed


class Analyzer:
    def __init__(self, rules: dict[str, Rule] | None = None):
        self.rules = dict(rules if rules is not None else RULES)

    def run(self, root: str | pathlib.Path,
            files: Iterable[str | pathlib.Path] | None = None
            ) -> AnalysisResult:
        root = pathlib.Path(root).resolve()
        paths = [pathlib.Path(f) if pathlib.Path(f).is_absolute()
                 else root / f for f in files] if files is not None \
            else default_files(root)
        ctxs = [FileContext.load(root, p) for p in paths if p.is_file()]
        by_rel = {c.rel: c for c in ctxs}

        raw: list[Finding] = []
        for rule in self.rules.values():
            for ctx in ctxs:
                if ctx.tree is not None and rule.applies_to(ctx.rel):
                    raw += list(rule.check_file(ctx))
            raw += list(rule.check_repo(root, ctxs))

        active: list[Finding] = []
        suppressed: list[Finding] = []
        for f in raw:
            ctx = by_rel.get(f.path)
            sup = ctx.suppressions.get(f.line) if ctx else None
            if sup and f.rule in sup.rules and sup.justification:
                sup.used.add(f.rule)
                suppressed.append(f)
            else:
                active.append(f)

        # the suppression mechanism polices itself
        for ctx in ctxs:
            for sup in ctx.suppressions.values():
                src = ctx.line_text(sup.line)
                if not sup.justification:
                    active.append(Finding(
                        "TANA002", ctx.rel, sup.line, 0,
                        "noqa without justification text (write "
                        "'# repro_torch: noqa[ID] -- why'); it suppresses "
                        "nothing", Severity.ERROR, src))
                    continue
                unknown = sorted(r for r in sup.rules if r not in self.rules)
                if unknown:
                    active.append(Finding(
                        "TANA002", ctx.rel, sup.line, 0,
                        f"noqa names unknown rule id(s) {unknown}",
                        Severity.ERROR, src))
                dead = sup.rules - sup.used - set(unknown)
                if dead:
                    active.append(Finding(
                        "TANA001", ctx.rel, sup.line, 0,
                        f"unused suppression for {sorted(dead)}: no such "
                        "finding on this line; delete the noqa",
                        Severity.WARNING, src))

        key = lambda f: (f.path, f.line, f.rule, f.message)
        return AnalysisResult(sorted(active, key=key),
                              sorted(suppressed, key=key),
                              [c.rel for c in ctxs])
