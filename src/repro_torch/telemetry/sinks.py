"""Telemetry sinks: where validated records go (a copy of
``repro/telemetry/sinks.py``).

A sink is anything with ``emit(record: dict)`` (and optionally
``close()``).  The recorder validates every record against the schema
*before* fan-out, so sinks can assume well-formed input.
"""
from __future__ import annotations

import json
import os
from typing import Any

__all__ = ["JsonlSink", "MemorySink"]


class MemorySink:
    """In-memory sink (tests, and callers that read the records back)."""

    def __init__(self) -> None:
        self.records: list[dict] = []

    def emit(self, rec: dict) -> None:
        self.records.append(rec)

    def close(self) -> None:  # pragma: no cover - symmetry with JsonlSink
        pass


class JsonlSink:
    """One JSON object per line, flushed per record.

    ``append=True`` continues an existing file — the ``--resume`` pathway:
    the resumed segment re-emits its own manifest (``resumed: true``) so
    ``summarize`` can count run segments, and the recorder, restored from
    the checkpoint (``load_state_dict``), continues its counter totals.

    Per-record flush is deliberate: telemetry exists for runs that die —
    a crash must not lose the rounds that led up to it.  The cost is one
    small host write per record, far below the per-step device work.
    """

    def __init__(self, path: str, *, append: bool = False) -> None:
        self.path = os.fspath(path)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._f: Any = open(self.path, "a" if append else "w")

    def emit(self, rec: dict) -> None:
        if self._f is None:
            raise ValueError(f"JsonlSink({self.path!r}) is closed")
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_jsonl(path: str) -> list[dict]:
    """Load and schema-validate a JSONL telemetry stream."""
    from repro_torch.telemetry.schema import SchemaError, validate_record

    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(f"{path}:{lineno}: not JSON: {e}") from e
            try:
                validate_record(rec)
            except SchemaError as e:
                raise SchemaError(f"{path}:{lineno}: {e}") from e
            records.append(rec)
    return records
