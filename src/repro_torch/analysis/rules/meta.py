"""TANA meta-rules: the suppression mechanism polices itself.

The :class:`~repro_torch.analysis.framework.Analyzer` emits these (it is
the only place that knows which suppressions matched); they are
registered here so they show in ``--list-rules``, are recognized inside
``noqa[...]`` and carry their severities in one place.
"""
from __future__ import annotations

from ..findings import Severity
from ..framework import Rule, register

_CONTRACT = "suppressions are scoped and justified"


@register
class UnusedSuppression(Rule):
    id = "TANA001"
    severity = Severity.WARNING
    description = ("noqa that suppresses nothing on its line: dead "
                   "suppressions are deleted, not accumulated")
    contract = _CONTRACT


@register
class BareSuppression(Rule):
    id = "TANA002"
    severity = Severity.ERROR
    description = ("noqa without the '-- justification' text, or naming an "
                   "unknown rule id; it suppresses nothing")
    contract = _CONTRACT
