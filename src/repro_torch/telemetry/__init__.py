"""Unified run telemetry shared by both engines: the counterpart of
``repro/telemetry`` (the same record schema, ``SCHEMA_VERSION`` 1, so
either package's ``summarize``/``diff`` reads the other's runs).

Typical wiring::

    from repro_torch.telemetry import JsonlSink, MetricsRecorder

    rec = MetricsRecorder(
        sinks=[JsonlSink("run.jsonl")], metrics_every=5, record_spans=True
    )
    rec.manifest({"topology": topo.describe(), ...})
    sim = DecentralizedSimulator(..., telemetry=rec)

Then ``python -m repro_torch.telemetry summarize run.jsonl``.
"""
from repro_torch.telemetry.recorder import (
    NO_SPAN, MetricsRecorder, coalesce_into, host_grad_norm,
)
from repro_torch.telemetry.schema import (
    KINDS, SCHEMA_VERSION, SchemaError, validate_record,
)
from repro_torch.telemetry.sinks import JsonlSink, MemorySink, read_jsonl
from repro_torch.telemetry.summarize import (
    diff_summaries, render_summary, summarize,
)

__all__ = [
    "MetricsRecorder",
    "NO_SPAN",
    "JsonlSink",
    "MemorySink",
    "read_jsonl",
    "SCHEMA_VERSION",
    "SchemaError",
    "KINDS",
    "validate_record",
    "coalesce_into",
    "host_grad_norm",
    "summarize",
    "render_summary",
    "diff_summaries",
]
