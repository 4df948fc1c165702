"""Pass 3 — the rebuild guard: the counterpart of ``repro/analysis/recompile.py``.

The reference's zero-mid-run-recompile invariant says that after warm-up
no training step traces or compiles anything new: time-varying topologies
rotate through the pre-enumerated ``Topology.distinct_programs``, fault
masks are runtime operands.  PyTorch runs eagerly and compiles nothing per
step, so in the port "a retrace" is whatever a step would build anew:

* an nvcc build of a kernel library (``kernels/_build.py``);
* a miss of a per-program device-table cache: K1/K2's weight and source
  tables (``kernels/gossip_update.py::_device_tables``), K3's tile tables
  (``kernels/stats.py::_tiles``);
* a program key an engine has not stepped before (``_step_cache`` of the
  simulator and of ``SPMDTrainer``): a new program, or a new bucket step
  (program, momentum, faults).

``watch_retrace`` / ``assert_no_retrace``
    Count those events inside a ``with`` block.  The hooks call ``note``,
    which costs a test of an empty list when no block is active.

``assert_executables_preenumerated``
    Every program key an engine used lies in the statically enumerable
    set (``Topology.distinct_programs`` for the simulator,
    ``SPMDTrainer.precompile_programs`` for the trainer).

Both engines take ``debug_no_retrace=True``: a step whose key was seen
before runs under ``assert_no_retrace``.
"""
from __future__ import annotations

import contextlib
import dataclasses

from repro_torch.analysis.report import RetraceError

__all__ = [
    "RetraceStats",
    "note",
    "watch_retrace",
    "assert_no_retrace",
    "guard",
    "used_program_keys",
    "allowed_program_keys",
    "assert_executables_preenumerated",
]

# the active ``watch_retrace`` frames; the hooks live deep in the kernel
# wrappers, so the frames are process-wide, as the reference's listener is
_frames: list["RetraceStats"] = []


@dataclasses.dataclass
class RetraceStats:
    """Counts observed while a ``watch_retrace`` frame was active."""

    label: str = ""
    builds: int = 0     # nvcc builds of a kernel library
    tables: int = 0     # per-program device-table cache misses
    programs: int = 0   # program keys an engine stepped for the first time

    @property
    def total(self) -> int:
        return self.builds + self.tables + self.programs

    @property
    def clean(self) -> bool:
        return self.total == 0


def note(kind: str) -> None:
    """Count one rebuild event, ``kind`` one of ``"builds"``, ``"tables"``,
    ``"programs"``, in every active frame."""
    for f in _frames:
        setattr(f, kind, getattr(f, kind) + 1)


@contextlib.contextmanager
def watch_retrace(label: str = ""):
    """Count nvcc builds, device-table misses and new program keys inside
    the ``with`` body."""
    stats = RetraceStats(label)
    _frames.append(stats)
    try:
        yield stats
    finally:
        _frames.remove(stats)


@contextlib.contextmanager
def assert_no_retrace(label: str = "", *, allow: int = 0):
    """Raise ``RetraceError`` if the body built more than ``allow`` things.

    Steady-state training sections run at 0 (the default); a warm-up that
    builds at first use runs outside the block or declares an allowance."""
    with watch_retrace(label) as stats:
        yield stats
    if stats.total > allow:
        who = f" in {label!r}" if label else ""
        raise RetraceError(
            f"mid-run rebuild{who}: {stats.builds} nvcc build(s), {stats.tables} "
            f"device table(s), {stats.programs} new program key(s) (allowed {allow}) — "
            "a step's program was not pre-enumerated or a table was rebuilt"
        )


def guard(enabled: bool, label: str):
    """The engines' ``debug_no_retrace`` guard: ``assert_no_retrace`` around
    a warm step when ``enabled``, else nothing."""
    return assert_no_retrace(label) if enabled else contextlib.nullcontext()


def used_program_keys(step_cache) -> set:
    """Program cache keys behind an engine ``_step_cache``'s entries.

    Strips the engines' wrappers — ``(key, "faulty")`` fault signatures,
    ``("__bucket__", key, has_m, faulty)`` bucket steps — and drops
    ``__``-prefixed internal keys (local and centralized steps) and the
    trainer's ``None`` programless key, as the reference does.
    """
    used = set()
    for k in step_cache:
        if k is None or isinstance(k, str):
            continue
        if isinstance(k, tuple) and len(k) == 2 and k[1] == "faulty":
            k = k[0]
            if k is None:
                continue
        if isinstance(k, tuple) and k and k[0] == "__bucket__":
            k = k[1]
        if isinstance(k, tuple) and k and isinstance(k[0], str) \
                and k[0].startswith("__"):
            continue
        used.add(k)
    return used


def allowed_program_keys(engine, n_epochs: int = 1) -> set:
    """The statically enumerable program-key set of either engine."""
    if hasattr(engine, "precompile_programs"):  # SPMDTrainer
        return {p.cache_key for p in engine.precompile_programs(n_epochs)}
    return {p.cache_key for _, p in engine.topology.distinct_programs(n_epochs)}


def assert_executables_preenumerated(engine, *, n_epochs: int = 1,
                                     require_used: bool = True) -> set:
    """Every program key an engine stepped must come from the enumerable
    set.  Returns the used key set; ``require_used`` guards against the
    assertion passing vacuously because no mixing step ran."""
    allowed = allowed_program_keys(engine, n_epochs)
    used = used_program_keys(engine._step_cache)
    if require_used and not used:
        raise RetraceError(
            "no program-keyed step ran at all — the run never exercised a "
            "mixing step (vacuous invariant)"
        )
    stray = used - allowed
    if stray:
        raise RetraceError(
            f"{len(stray)} program key(s) beyond the pre-enumerated program "
            f"set: {sorted(map(str, stray))[:4]} — a program was built "
            "mid-run that Topology.distinct_programs cannot see"
        )
    return used
