"""The port's contract linter: AST checks of ``repro_torch``'s own
invariants, with torch rules (the port's copy of ``repro.analysis``)::

    python -m repro_torch.analysis --check

It reads ``src/repro_torch/**/*.py``, ``examples/*_torch.py`` and
``chip_smoke.py``; suppressions are ``# repro_torch: noqa[ID] -- why``;
rule ids start with ``T``.  Its modules import only the standard library
and each other, but ``python -m repro_torch.analysis`` imports the
``repro_torch`` package first, and with it torch.

Public surface: :func:`run_analysis` (registry + file walk +
suppressions), the :data:`RULES` registry and the finding and baseline
primitives.
"""
from __future__ import annotations

import pathlib

from . import rules as _rules  # noqa: F401 (registers every rule family)
from .findings import (Finding, Severity, apply_baseline, baseline_index,
                       load_baseline, parse_suppressions, write_baseline)
from .framework import (AnalysisResult, Analyzer, FileContext, Rule, RULES,
                        default_files, register)

__all__ = ["Finding", "Severity", "Rule", "RULES", "Analyzer",
           "AnalysisResult", "FileContext", "run_analysis", "default_files",
           "register", "load_baseline", "baseline_index", "apply_baseline",
           "write_baseline", "parse_suppressions"]


def run_analysis(root: str | pathlib.Path, files=None,
                 rules: dict | None = None) -> AnalysisResult:
    """Run every registered rule (or ``rules``) over ``files`` under
    ``root`` (default: the port's file set, :func:`default_files`)."""
    return Analyzer(rules).run(root, files)
