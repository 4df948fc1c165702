"""Static analysis over the port's gossip stack: the counterpart of
``repro/analysis``.

Run the whole pipeline with ``python -m repro_torch.analysis --all``
(``__main__.py``).  Submodules are imported lazily, so that the kernel
wrappers can pull ``analysis.budget`` and ``analysis.recompile`` without
the other passes:

  * ``analysis.invariants``  — mixing-program and bucket-layout invariants
  * ``analysis.collectives`` — the collective linter over ``Comm``'s op
    record, and the dispatch-loop lint of the engine sources
  * ``analysis.recompile``   — the rebuild guard (nvcc builds, device
    tables, program keys after warm-up)
  * ``analysis.budget``      — Hopper launch budgets of K1-K4

Only the shared report vocabulary is eager.
"""
from repro_torch.analysis.report import (
    AnalysisViolation,
    BudgetViolation,
    CollectiveViolation,
    Finding,
    InvariantViolation,
    PassReport,
    RetraceError,
    run_pass,
)

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
