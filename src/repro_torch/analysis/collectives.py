"""Pass 2 — the collective linter: the counterpart of
``repro/analysis/collectives.py``, read from ``Comm``'s op record
(``launch/comm.py``: ``Comm.recording``) where the reference reads HLO.

Ranks deadlock in two ways:

  1. **Sequence divergence.**  Collectives rendezvous by (kind, peers,
     order, size).  Two realizations of one step that can run side by side
     on different ranks — a program's ``apply_shard`` and its masked twin
     ``apply_shard_masked`` — MUST issue the same sequence: dropped edges
     still travel with weight zero.  If masking changed the permute
     schedule, a rank running masked against one running unmasked would
     wait at different rendezvous forever.
  2. **Unbounded dispatch.**  A loop that enqueues a collective per bucket
     must bound what is in flight (the reference's
     ``MAX_INFLIGHT_BUCKETS``).

Plus the hot-path ban: a colorable graph never all-gathers (the dense
``GatherRow`` fallback leaking back).

  * ``collective_signature`` — the ordered (kind, pairs, bytes) of a record;
  * ``assert_signatures_consistent`` — equality across co-executable
    realizations, the first diverging op spelled out;
  * ``lint_no_forbidden`` — the all-gather ban, offending ops named;
  * ``lint_dispatch_loops`` / ``lint_engine_sources`` — the AST lint of
    the engines' sources: a loop dispatching per-bucket work must consult
    ``MAX_INFLIGHT_BUCKETS`` or wait on in-flight work inside the loop;
  * ``record_programs`` — run on every rank of a world (``spawn_world``):
    each program's ``apply_shard`` and ``apply_shard_masked`` records.

The HLO-bound half of the reference's module is ``launch/hlo_analysis.py``:
op accounting over the dispatched op stream, with the collectives of this
record mapped to the reference's kinds, ``CollectiveReport``,
``assert_no_all_gather`` and the f8 wire widths.
"""
from __future__ import annotations

import ast
import os
import re

from repro_torch.analysis.report import CollectiveViolation, Finding

__all__ = [
    "collective_signature",
    "assert_signatures_consistent",
    "lint_no_forbidden",
    "lint_dispatch_loops",
    "lint_engine_sources",
    "record_programs",
]


def collective_signature(ops) -> tuple:
    """Ordered (kind, pairs, bytes) of a ``Comm`` op record: what two ranks
    running side by side must agree on."""
    return tuple((op.kind, op.pairs, op.nbytes) for op in ops)


def assert_signatures_consistent(signatures: dict) -> None:
    """All labelled realizations must carry the identical collective
    sequence (kinds, order, peers, bytes)."""
    if len(signatures) < 2:
        return
    items = sorted(signatures.items())
    ref_label, ref = items[0]
    for label, sig in items[1:]:
        if sig == ref:
            continue
        detail = f"{len(ref)} vs {len(sig)} collectives"
        for i, (a, b) in enumerate(zip(ref, sig)):
            if a != b:
                detail = f"op {i}: {a} vs {b}"
                break
        raise CollectiveViolation(
            f"collective sequences diverge between co-executable realizations "
            f"{ref_label!r} and {label!r} ({detail}) — ranks selecting different "
            "realizations would rendezvous at different collectives and deadlock"
        )


def lint_no_forbidden(ops, forbid=("all_gather",)) -> dict:
    """The hot-path ban over an op record; returns the count of each kind."""
    counts: dict[str, int] = {}
    bad = []
    for i, op in enumerate(ops):
        counts[op.kind] = counts.get(op.kind, 0) + 1
        if op.kind in forbid:
            bad.append(f"op {i}: {op.kind} of {op.nbytes} B")
    if bad:
        raise CollectiveViolation(
            "forbidden collective(s) on the hot path: " + ", ".join(bad)
            + " — the dense GatherRow fallback leaked back in")
    return counts


# -- dispatch-window lint ----------------------------------------------------

# Dispatch loops iterate per-bucket widths or work; host-side slicing loops
# iterate ``segments`` and launch nothing, so they are NOT matched.
_BUCKET_NAME = re.compile(r"width|bucket|inflight", re.IGNORECASE)
# what bounds a window in the port: the window constant, or waiting on work
_BOUNDS = {"MAX_INFLIGHT_BUCKETS", "synchronize", "wait"}


def _names_in(node) -> set[str]:
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def _is_bucket_loop(loop: ast.AST) -> bool:
    """A for/while loop that iterates bucket-shaped work and makes calls."""
    if isinstance(loop, ast.For):
        iter_names = _names_in(loop.iter)
    elif isinstance(loop, ast.While):
        iter_names = _names_in(loop.test)
    else:
        return False
    if not any(_BUCKET_NAME.search(n) for n in iter_names):
        return False
    return any(isinstance(sub, ast.Call) for stmt in loop.body for sub in ast.walk(stmt))


def _loop_is_bounded(loop: ast.AST) -> bool:
    names = set()
    for stmt in loop.body:
        names |= _names_in(stmt)
    return bool(names & _BOUNDS)


def lint_dispatch_loops(source: str, path: str = "<string>") -> list[Finding]:
    """Flag loops that can queue unbounded collective-bearing dispatches:
    a loop over per-bucket work that makes calls must, inside its body,
    consult ``MAX_INFLIGHT_BUCKETS`` or wait on in-flight work."""
    findings = []
    tree = ast.parse(source, filename=path)
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for loop in ast.walk(fn):
            if _is_bucket_loop(loop) and not _loop_is_bounded(loop):
                findings.append(Finding(
                    "collectives", f"{path}:{loop.lineno} ({fn.name})",
                    "per-bucket dispatch loop has no in-flight bound: neither "
                    "MAX_INFLIGHT_BUCKETS nor a wait appears in the loop body"))
    return findings


def lint_engine_sources(paths=None) -> list[Finding]:
    """The dispatch-window lint over the port's engine modules."""
    if paths is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        paths = [os.path.join(root, *p) for p in (
            ("core", "simulator.py"), ("core", "buckets.py"), ("core", "schedule.py"),
            ("launch", "train.py"), ("kernels", "gossip_update.py"))]
    findings = []
    for path in paths:
        with open(path) as f:
            findings.extend(lint_dispatch_loops(f.read(), path))
    return findings


def record_programs(comm, programs) -> dict:
    """On one rank of a world of ``programs``' size: each program's
    ``apply_shard`` and ``apply_shard_masked`` (every node alive) on a
    small row, each recorded.  ``programs`` maps a label to a program;
    returns ``label -> {"apply_shard": ops, "apply_shard_masked": ops,
    "colorable": whether the program has permute tables}`` (the ops a
    list of ``CollectiveOp``)."""
    import torch

    x = torch.arange(4, dtype=torch.float32, device=comm.device) + comm.rank
    alive = torch.ones(comm.world, dtype=torch.float32, device=comm.device)
    out = {}
    for label, prog in programs.items():
        with comm.recording() as plain:
            prog.apply_shard(x, comm)
        with comm.recording() as masked:
            prog.apply_shard_masked(x, comm, alive)
        out[label] = {"apply_shard": plain, "apply_shard_masked": masked,
                      "colorable": prog.permute_tables() is not None}
    return out
