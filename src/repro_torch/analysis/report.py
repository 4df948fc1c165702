"""Shared result types for the static-analysis pass pipeline: a copy of
``repro/analysis/report.py``.

Every pass has two consumption modes:

  * **assertion mode** (tests, engine debug hooks): the ``verify_*`` /
    ``assert_*`` / ``check_*`` entry points raise a subclass of
    ``AnalysisViolation`` — itself an ``AssertionError``, so existing
    ``pytest.raises(AssertionError)`` call sites keep working — on the
    first violation.
  * **report mode** (the ``python -m repro_torch.analysis`` CLI): ``run_pass``
    wraps any number of checks, converts violations into ``Finding``s and
    returns a ``PassReport`` so one broken invariant doesn't hide the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

__all__ = [
    "AnalysisViolation",
    "InvariantViolation",
    "CollectiveViolation",
    "RetraceError",
    "BudgetViolation",
    "Finding",
    "PassReport",
    "run_pass",
]


class AnalysisViolation(AssertionError):
    """Base class for every failure a static-analysis pass can raise."""


class InvariantViolation(AnalysisViolation):
    """Mixing-program / bucket-layout invariant broken (``invariants``)."""


class CollectiveViolation(AnalysisViolation):
    """Collective sequence inconsistency or forbidden op (``collectives``)."""


class RetraceError(AnalysisViolation):
    """A warm step built a kernel, a device table or a program key
    (``recompile``)."""


class BudgetViolation(AnalysisViolation):
    """A kernel launch exceeds the card's limits (``budget``)."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation, attributed to the pass and the object it checked."""

    pass_name: str
    subject: str
    message: str

    def __str__(self):
        return f"[{self.pass_name}] {self.subject}: {self.message}"


@dataclasses.dataclass
class PassReport:
    """Outcome of one pass over a batch of subjects."""

    name: str
    checked: int = 0
    findings: list[Finding] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def add(self, subject: str, message: str) -> None:
        self.findings.append(Finding(self.name, subject, message))

    def merge(self, other: "PassReport") -> None:
        self.checked += other.checked
        self.findings.extend(other.findings)

    def raise_if_failed(self) -> None:
        if self.findings:
            raise AnalysisViolation(
                f"pass {self.name!r}: {len(self.findings)} violation(s)\n"
                + "\n".join(f"  {f}" for f in self.findings)
            )

    def summary(self) -> str:
        status = "ok" if self.ok else f"FAIL ({len(self.findings)})"
        return f"{self.name}: {self.checked} checked, {status}"


def run_pass(
    name: str, subjects: Iterable[tuple[str, Callable[[], object]]]
) -> PassReport:
    """Run ``(label, thunk)`` checks, collecting violations per subject."""
    report = PassReport(name)
    for label, thunk in subjects:
        report.checked += 1
        try:
            thunk()
        except AnalysisViolation as e:
            report.add(label, str(e))
    return report
