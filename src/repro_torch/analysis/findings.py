"""Finding, suppression and baseline primitives of the port's contract
linter (the port's copy of ``repro.analysis.findings``).

A finding is identified across revisions by its *fingerprint* ``(rule,
path, stripped source line)`` rather than a line number, so a baseline
survives unrelated edits above the flagged line.  Suppressions are in
source, with the port's own marker::

    expr_that_violates()  # repro_torch: noqa[TRNG002] -- why it is fine

The justification text is mandatory (a bare noqa does not suppress and is
itself reported as TANA002); a noqa that suppresses nothing is reported as
TANA001, so dead suppressions cannot accumulate.  The reference linter's
``# repro:`` marker is not this one, and each linter ignores the other's.
"""
from __future__ import annotations

import dataclasses
import io
import json
import pathlib
import re
import tokenize


class Severity:
    ERROR = "error"
    WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # e.g. "TRNG001"
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int           # 0-based
    message: str
    severity: str = Severity.ERROR
    source: str = ""   # stripped text of the flagged line (fingerprint)

    @property
    def fingerprint(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.source)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule} [{self.severity}] {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


NOQA_RE = re.compile(
    r"#\s*repro_torch:\s*noqa\[([A-Za-z0-9_\s,]+)\]\s*(?:--\s*(\S.*))?")
RULE_ID_RE = re.compile(r"^[A-Z]{2,5}\d{3}$")


@dataclasses.dataclass
class Suppression:
    line: int                  # 1-based line the noqa comment sits on
    rules: frozenset           # rule ids it names
    justification: str        # mandatory; "" means invalid
    used: set = dataclasses.field(default_factory=set)


def parse_suppressions(source: str) -> dict[int, Suppression]:
    """1-based line number -> :class:`Suppression` for every noqa comment.
    Only real ``#`` comments count (a noqa inside a string is not one);
    a file that does not tokenize is scanned line by line."""
    try:
        comments = [(tok.start[0], tok.string) for tok in
                    tokenize.generate_tokens(io.StringIO(source).readline)
                    if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        comments = list(enumerate(source.splitlines(), start=1))
    out: dict[int, Suppression] = {}
    for i, text in comments:
        m = NOQA_RE.search(text)
        if m:
            rules = frozenset(r.strip() for r in m.group(1).split(",")
                              if r.strip())
            out[i] = Suppression(i, rules, (m.group(2) or "").strip())
    return out


# ---------------------------------------------------------------- baseline

BASELINE_VERSION = 1


def load_baseline(path: str | pathlib.Path) -> list[dict]:
    """A baseline file's entries; every entry must carry a
    justification."""
    payload = json.loads(pathlib.Path(path).read_text())
    if payload.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{payload.get('version')!r}")
    entries = payload.get("entries", [])
    for e in entries:
        for k in ("rule", "path", "fingerprint", "justification"):
            if not str(e.get(k, "")).strip():
                raise ValueError(f"baseline entry {e!r} is missing a "
                                 f"non-empty {k!r}")
    return entries


def baseline_index(entries: list[dict]) -> set[tuple[str, str, str]]:
    return {(e["rule"], e["path"], e["fingerprint"]) for e in entries}


def apply_baseline(findings: list[Finding], entries: list[dict]
                   ) -> tuple[list[Finding], list[dict]]:
    """``(new findings, stale entries)``: a finding is absorbed when its
    fingerprint matches an entry; an entry matching no finding is stale
    and must be pruned."""
    idx = baseline_index(entries)
    live = {f.fingerprint for f in findings}
    return ([f for f in findings if f.fingerprint not in idx],
            [e for e in entries
             if (e["rule"], e["path"], e["fingerprint"]) not in live])


def write_baseline(path: str | pathlib.Path, findings: list[Finding],
                   old_entries: list[dict] | None = None) -> list[dict]:
    """Write ``findings`` as a baseline, keeping the justifications of
    ``old_entries`` by fingerprint; a new entry gets a placeholder that a
    person must replace."""
    just = {(e["rule"], e["path"], e["fingerprint"]): e["justification"]
            for e in (old_entries or [])}
    entries, seen = [], set()
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        if f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        entries.append({"rule": f.rule, "path": f.path,
                        "fingerprint": f.source,
                        "justification": just.get(
                            f.fingerprint,
                            "GRANDFATHERED: justify before extending")})
    pathlib.Path(path).write_text(json.dumps(
        {"version": BASELINE_VERSION, "entries": entries}, indent=1) + "\n")
    return entries
