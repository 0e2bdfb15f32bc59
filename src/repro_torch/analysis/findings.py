"""Structured findings: what every audit rule returns (reference:
``repro/analysis/findings.py``).

A rule never asserts or prints: it returns a list of :class:`Finding`, so
one rule backs a gate (any :func:`errors`), a test assertion or the JSON
report of ``python -m repro_torch.analysis``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List

SEV_ERROR = "error"
SEV_INFO = "info"


@dataclasses.dataclass
class Finding:
    """One audit result: the registry id of its ``rule``, a ``severity``, a
    message and rule-specific machine-readable ``data``."""
    rule: str
    severity: str
    message: str
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.severity}:{self.rule}: {self.message}"


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == SEV_ERROR]
