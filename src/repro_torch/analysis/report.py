"""Findings, severities, suppressions and the machine-readable report.

The port's copy of ``repro.analysis.report``, under the same names. Every
analysis pass (the port has ``planlint``) emits
:class:`Finding` records into one shared :class:`Report`. A finding is a
*claimed contract violation*: it names the check that fired, the subject
(stack / layer / autotune key / jaxpr location), a human message and a
machine-readable ``details`` dict, so the JSON artifact can be diffed and
gated in CI without parsing prose.

Suppressions are explicit and reasoned: a :class:`Suppression` matches
``(check, subject glob)`` and MUST carry a reason string. Suppressed
findings are not dropped — they move to the report's ``suppressed`` list
(with the reason attached), so there is never a silent baseline file.
"""
from __future__ import annotations

import dataclasses
import enum
import fnmatch
import json
from typing import Dict, List, Optional, Sequence


class Severity(enum.IntEnum):
    """Ordered so ``severity >= fail_on`` implements the exit-code gate."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    @classmethod
    def parse(cls, name: str) -> "Severity":
        try:
            return cls[name.upper()]
        except KeyError:
            raise ValueError(
                f"unknown severity {name!r} (info/warning/error)") from None


@dataclasses.dataclass(frozen=True)
class Finding:
    """One claimed violation of a quantization contract."""

    check: str                 # e.g. "intlint/float-leak"
    severity: Severity
    subject: str               # "kws/conv3", "autotune:(3,3,1)", ...
    message: str
    details: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "check": self.check,
            "severity": self.severity.name.lower(),
            "subject": self.subject,
            "message": self.message,
            "details": _jsonable(self.details),
        }


@dataclasses.dataclass(frozen=True)
class Suppression:
    """An explicit, reasoned exemption: matches check + subject globs."""

    check: str                 # glob over Finding.check
    subject: str               # glob over Finding.subject
    reason: str                # mandatory — no silent baselines

    def __post_init__(self):
        if not self.reason.strip():
            raise ValueError(
                f"Suppression({self.check!r}, {self.subject!r}) needs a "
                "non-empty reason — silent baselines are not allowed")

    def matches(self, f: Finding) -> bool:
        return fnmatch.fnmatchcase(f.check, self.check) and \
            fnmatch.fnmatchcase(f.subject, self.subject)


class Report:
    """Accumulates findings across passes; renders text + JSON."""

    def __init__(self, suppressions: Sequence[Suppression] = ()):
        self.suppressions = tuple(suppressions)
        self.findings: List[Finding] = []
        self.suppressed: List[Dict] = []   # finding dict + reason
        self.proofs: List[Dict] = []       # what the passes *proved* clean
        self.counters: Dict[str, int] = {}

    # -- pass API -----------------------------------------------------------

    def add(self, check: str, severity: Severity, subject: str, message: str,
            **details) -> Optional[Finding]:
        f = Finding(check, severity, subject, message, details)
        for s in self.suppressions:
            if s.matches(f):
                self.suppressed.append({**f.to_dict(), "reason": s.reason})
                return None
        self.findings.append(f)
        return f

    def error(self, check, subject, message, **details):
        return self.add(check, Severity.ERROR, subject, message, **details)

    def warning(self, check, subject, message, **details):
        return self.add(check, Severity.WARNING, subject, message, **details)

    def info(self, check, subject, message, **details):
        return self.add(check, Severity.INFO, subject, message, **details)

    def prove(self, check: str, subject: str, statement: str, **details):
        """Record a positively-established property (the report's value is
        as much the list of proofs as the list of findings)."""
        self.proofs.append({"check": check, "subject": subject,
                            "statement": statement,
                            "details": _jsonable(details)})

    def count(self, key: str, n: int = 1):
        self.counters[key] = self.counters.get(key, 0) + n

    def merge(self, other: "Report"):
        self.findings.extend(other.findings)
        self.suppressed.extend(other.suppressed)
        self.proofs.extend(other.proofs)
        for k, v in other.counters.items():
            self.count(k, v)

    # -- gate ---------------------------------------------------------------

    def worst(self) -> Optional[Severity]:
        return max((f.severity for f in self.findings), default=None)

    def exit_code(self, fail_on: Severity = Severity.WARNING) -> int:
        return int(any(f.severity >= fail_on for f in self.findings))

    # -- rendering ----------------------------------------------------------

    def to_dict(self) -> Dict:
        by_sev: Dict[str, int] = {}
        for f in self.findings:
            k = f.severity.name.lower()
            by_sev[k] = by_sev.get(k, 0) + 1
        return {
            "format": 1,
            "tool": "repro_torch.analysis",
            "summary": {
                "findings": len(self.findings),
                "by_severity": by_sev,
                "suppressed": len(self.suppressed),
                "proofs": len(self.proofs),
            },
            "counters": dict(sorted(self.counters.items())),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": self.suppressed,
            "proofs": self.proofs,
        }

    def write_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")

    def render_text(self) -> str:
        lines = []
        for f in sorted(self.findings, key=lambda f: -f.severity):
            lines.append(
                f"{f.severity.name:7s} {f.check:32s} {f.subject}: {f.message}")
        for s in self.suppressed:
            lines.append(f"suppressed      {s['check']:32s} {s['subject']}: "
                         f"{s['message']} [reason: {s['reason']}]")
        lines.append(
            f"analysis: {len(self.findings)} finding(s) "
            f"({len(self.suppressed)} suppressed), "
            f"{len(self.proofs)} properties proved")
        return "\n".join(lines)


def _jsonable(x):
    """Best-effort conversion of details values for json.dump."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (str, bool)) or x is None:
        return x
    if isinstance(x, float):
        return x if x == x and abs(x) != float("inf") else repr(x)
    if isinstance(x, int):
        return x
    try:
        import numpy as np
        if isinstance(x, np.generic):
            return _jsonable(x.item())
    except Exception:
        pass
    return repr(x)
