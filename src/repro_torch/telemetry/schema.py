"""Typed record schema for the run-telemetry stream: a copy of
``repro/telemetry/schema.py`` (same ``SCHEMA_VERSION``, kinds and fields),
so that either package's ``summarize``/``diff`` reads the other's runs.

Every record a :class:`~repro_torch.telemetry.MetricsRecorder` emits is a flat
JSON-serializable dict with a ``kind`` discriminator.  The schema is
deliberately small — five kinds cover everything both engines observe:

  manifest   run provenance, emitted once per run segment (a ``--resume``
             appends a second manifest with ``resumed: true``)
  counter    monotone accumulations billed at dispatch time
             (``comm_bytes``, ``permutes``, ``program_applications``)
  gauge      point-in-time scalars (``loss``, ``xi``, ``lr``,
             ``grad_norm``)
  span       measured wall-clock durations (``round`` per training step,
             ``bucket`` per overlap-scheduled dispatch) with
             deadline-overrun attribution on ``round`` spans
  event      discrete occurrences: controller ``transition`` /
             ``controller`` (rearm/redensify reasons, same-step
             coalesced), membership changes (``join`` / ``rejoin`` /
             ``depart`` / ``membership``), ``checkpoint_save`` /
             ``checkpoint_restore``
  variance   the streamed DBench signal: ``variance_report`` metrics over
             the per-node parameter-norm matrix (paper Fig. 5), with the
             per-layer breakdown

``validate_record`` is the single structural gate: the recorder, the
JSONL reader and the ``summarize``/``diff`` CLI all call it, so a
malformed emission fails at the producing site, not in a consumer long
after the run.
"""
from __future__ import annotations

from typing import Any

SCHEMA_VERSION = 1

__all__ = ["SCHEMA_VERSION", "SchemaError", "validate_record", "KINDS"]


class SchemaError(ValueError):
    """A record violating the telemetry schema."""


_NUM = (int, float)


def _is_num(v: Any) -> bool:
    return isinstance(v, _NUM) and not isinstance(v, bool)


# kind -> {field: checker}; fields not listed are forbidden except the
# optional ones declared in _OPTIONAL.
KINDS = {
    "manifest": {"schema": lambda v: v == SCHEMA_VERSION,
                 "run": lambda v: isinstance(v, dict)},
    "counter": {"step": lambda v: isinstance(v, int) and v >= 0,
                "name": lambda v: isinstance(v, str) and v,
                "inc": _is_num,
                "total": _is_num},
    "gauge": {"step": lambda v: isinstance(v, int) and v >= 0,
              "name": lambda v: isinstance(v, str) and v,
              "value": lambda v: v is None or _is_num(v)},
    "span": {"step": lambda v: isinstance(v, int) and v >= 0,
             "name": lambda v: isinstance(v, str) and v,
             "ms": lambda v: _is_num(v) and v >= 0},
    "event": {"step": lambda v: isinstance(v, int) and v >= 0,
              "name": lambda v: isinstance(v, str) and v},
    "variance": {"step": lambda v: isinstance(v, int) and v >= 0,
                 "metrics": lambda v: isinstance(v, dict) and v
                 and all(isinstance(k, str) and (x is None or _is_num(x))
                         for k, x in v.items())},
}

_OPTIONAL = {
    "span": {
        # round spans under a GossipDeadline model attribute overruns
        "deadline_ms": _is_num,
        "overrun": lambda v: isinstance(v, bool),
        "mix": lambda v: isinstance(v, bool),
        # bucket spans carry their dispatch index
        "index": lambda v: isinstance(v, int) and v >= 0,
    },
    "event": {"data": lambda v: isinstance(v, dict)},
    "variance": {
        "per_layer": lambda v: isinstance(v, dict)
        and all(isinstance(k, str) and isinstance(x, list)
                for k, x in v.items()),
    },
}


def validate_record(rec: Any) -> None:
    """Raise :class:`SchemaError` unless ``rec`` is a well-formed record."""
    if not isinstance(rec, dict):
        raise SchemaError(f"record must be a dict, got {type(rec).__name__}")
    kind = rec.get("kind")
    if kind not in KINDS:
        raise SchemaError(f"unknown record kind {kind!r}")
    required = KINDS[kind]
    optional = _OPTIONAL.get(kind, {})
    for field, check in required.items():
        if field not in rec:
            raise SchemaError(f"{kind} record missing field {field!r}")
        if not check(rec[field]):
            raise SchemaError(
                f"{kind} record field {field!r} has invalid value "
                f"{rec[field]!r}"
            )
    for field, value in rec.items():
        if field == "kind" or field in required:
            continue
        if field not in optional:
            raise SchemaError(f"{kind} record has unknown field {field!r}")
        if not optional[field](value):
            raise SchemaError(
                f"{kind} record field {field!r} has invalid value {value!r}"
            )
