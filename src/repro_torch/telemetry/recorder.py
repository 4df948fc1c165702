"""The shared run-telemetry recorder both engines emit into: the
counterpart of ``repro/telemetry/recorder.py``.

One :class:`MetricsRecorder` instance rides a whole run.  It is host-side
Python: it launches no kernel and reads the device only where a record
needs a value (the loss, the norm matrix, Ξ), and only when a sink will
take the record.

Cost model, so callers know exactly what they pay:

  * no sinks (the default every engine constructs): every emitting method
    returns at once, ``due`` is always False and ``timing`` is False, so
    the engines never synchronize the device, call ``.item()`` or copy a
    tensor to the host for telemetry;
  * sinks attached (``--telemetry``): counters, gauges and events cost a
    dict update and a JSONL line; on a metrics step (``metrics_every``)
    the engine copies the losses and the (n, n_leaves) norm matrix to the
    host once; span timing additionally requires ``record_spans=True``
    (the CLI sets it).  On a CUDA device the trainer's ``round`` is then
    timed by CUDA events at ``train_step``'s boundaries, read without a
    synchronize once a later step finds them done (or at ``close`` and
    ``state_dict``), so its records may trail the step's other records;
    the simulator, and any engine on the CPU, synchronizes the device at
    the end of every step and reads the host clock.

Spans inside a step (``span``) are off unless a ``device_trace`` context
is open: off, ``span`` returns one shared no-op context after a single
attribute check.  Inside the context each span records its name, step
and parent, the host clock and a CUDA timing event (the host clock on the
CPU) at entry and exit, and a ``repro.<name>`` profiler range, so an
active ``torch.profiler`` shows it on the kernels' clock; nothing
synchronizes until the context closes, once.  Span records stay in
memory (the context's list): the JSONL stream does not carry them.
Code that holds no recorder (the model's layers) marks its spans with
``trace_span`` and counts with ``trace_count``, which reach the device
trace open in the process, if any, and are no-ops otherwise; the counts
land in the context's list as ``counts`` ({name: {step: total}}).  Both
mark the forward pass: they are no-ops too while autograd runs a backward
pass, so a block under activation checkpointing, which runs its forward
again there, is not counted twice.

Same-step event coalescing (``coalesce_into``) lives here, ONE
implementation, and the consensus controller routes its transition /
rearm / redensify log through it, so the simulator and the trainer
produce identical event streams for identical runs.

A gossip deadline (``GossipDeadline``'s ``deadline_ms``, set by the
engines through ``configure``) turns round timing on even without sinks:
every ``round`` span is measured (the engine synchronizes the device once
a step, since overruns are counted as the run goes), kept in ``round_ms``
and marked as an overrun when it is longer than the deadline.  The trace
is observational: the seeded model drives the masks.

A checkpoint carries the recorder's run totals (``state_dict``: counter
totals, rounds, overruns, events), and ``load_state_dict`` continues them
on a resumed run: ``rounds_total``/``overruns_total`` count both segments.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Optional

import numpy as np
import torch

from repro_torch.telemetry.schema import SCHEMA_VERSION, validate_record

__all__ = ["MetricsRecorder", "coalesce_into", "host_grad_norm", "NO_SPAN", "TraceRecords",
           "trace_span", "trace_count"]

# columns per chunk of ``host_grad_norm``: bounds its float32 temporaries
GRAD_NORM_CHUNK = 1 << 24
# rounds timed by CUDA events that may wait unread; past this many the
# oldest is waited for (a step's launch queue holds less than one step)
ROUND_LAG = 16
# what ``span`` returns with tracing off: one shared no-op context
NO_SPAN = nullcontext()


def coalesce_into(events: list, step: int, reason: str) -> Optional[str]:
    """Append ``(step, reason)`` to an event log, coalescing same-step
    entries: distinct reasons observed in one step merge into a single
    ``"a+b"`` entry, duplicates are dropped (re-arming is idempotent
    within a step).  Returns the entry's merged reason string, or None
    when the reason was already present.  This is the single coalescing
    implementation: ``ConsensusController._log_event`` delegates here,
    so both engines share its semantics by construction.
    """
    step = int(step)
    reason = str(reason)
    if events and events[-1][0] == step:
        prev = events[-1][1]
        if reason in prev.split("+"):
            return None
        merged = f"{prev}+{reason}"
        events[-1] = (step, merged)
        return merged
    events.append((step, reason))
    return reason


def host_grad_norm(grads) -> float:
    """Global L2 norm of a flat (rows, P) gradient buffer: one float32 sum
    of squares per column chunk of ``GRAD_NORM_CHUNK``, the chunks summed
    on the device in float64, and a single host read at the end.  A buffer
    that gathers its own column chunks (``columns(a, b)``: the simulator's
    split state, whose chunks come to its first card) gives them so."""
    take = getattr(grads, "columns", None) or (lambda a, b: grads[..., a:b])
    total = torch.zeros((), dtype=torch.float64, device=grads.device)
    for a in range(0, grads.shape[-1], GRAD_NORM_CHUNK):
        total += take(a, a + GRAD_NORM_CHUNK).float().square().sum()
    return float(total.sqrt())


class _EventPool:
    """CUDA timing events, reused across steps and traces."""

    def __init__(self):
        self.free: list = []

    def mark(self):
        """An event recorded now on the current stream."""
        ev = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def give(self, *events) -> None:
        self.free.extend(events)


class _Span:
    """One span of an open device trace: a context manager that marks its
    entry and exit on the host clock and the device's (an event, or the
    host clock again on the CPU) inside a ``repro.<name>`` profiler range."""

    __slots__ = ("trace", "name", "step", "parent", "range", "h0", "h1", "d0", "d1")

    def __init__(self, trace: "_SpanTrace", name: str, step: Optional[int]):
        self.trace, self.name, self.step = trace, name, step
        self.d1 = None

    def __enter__(self):
        tr = self.trace
        self.parent = tr.stack[-1] if tr.stack else None
        if self.step is None and self.parent is not None:
            self.step = self.parent.step
        tr.stack.append(self)
        tr.spans.append(self)
        self.range = torch.profiler.record_function("repro." + self.name)
        self.range.__enter__()
        self.h0 = time.perf_counter()
        self.d0 = tr.mark()
        return self

    def __exit__(self, *exc):
        tr = self.trace
        self.d1 = tr.mark()
        self.h1 = time.perf_counter()
        self.range.__exit__(*exc)
        tr.stack.pop()
        return False


class _SpanTrace:
    """The spans of one ``device_trace`` context, resolved when it closes."""

    def __init__(self, pool: Optional[_EventPool], device):
        self.pool, self.device = pool, device    # pool None: the host clock
        self.stack: list = []
        self.spans: list = []
        self.counts: dict = {}    # name -> {step: total}

    def count(self, name: str, inc) -> None:
        """Add ``inc`` to ``name``'s total of the step of the innermost open
        span (None outside every span)."""
        step = self.stack[-1].step if self.stack else None
        per = self.counts.setdefault(name, {})
        per[step] = per.get(step, 0) + inc

    def mark(self):
        return time.perf_counter() if self.pool is None else self.pool.mark()

    def resolve(self) -> list:
        """One synchronize, then a record per closed span: name, step,
        parent's name, device ms (entry mark to exit mark: the stream's
        time in the span, idle included), host ms and self device ms (the
        span less its children's device ms)."""
        spans = [sp for sp in self.spans if sp.d1 is not None]
        if self.pool is not None:
            torch.cuda.synchronize(self.device)
            device_ms = [sp.d0.elapsed_time(sp.d1) for sp in spans]
            for sp in self.spans:
                self.pool.give(*(e for e in (sp.d0, sp.d1) if e is not None))
        else:
            device_ms = [(sp.d1 - sp.d0) * 1e3 for sp in spans]
        children = {}
        for sp, ms in zip(spans, device_ms):
            if sp.parent is not None:
                children[id(sp.parent)] = children.get(id(sp.parent), 0.0) + ms
        return [{"name": sp.name, "step": sp.step,
                 "parent": None if sp.parent is None else sp.parent.name,
                 "device_ms": ms, "host_ms": (sp.h1 - sp.h0) * 1e3,
                 "self_ms": ms - children.get(id(sp), 0.0)}
                for sp, ms in zip(spans, device_ms)]


class TraceRecords(list):
    """A device trace's span records, in the order the spans opened, and
    its ``counts``: {name: {step: total}} of ``trace_count``."""

    counts: dict


# the device trace open in this process (``device_trace``), if any
_OPEN: list = []


def _forward_trace():
    """The device trace open in the process, or None when none is open or
    autograd runs a backward pass (a checkpointed block's recompute)."""
    if not _OPEN or torch._C._current_graph_task_id() != -1:
        return None
    return _OPEN[0]


def trace_span(name: str):
    """A span of the device trace open in the process (its step the
    parent's), or ``NO_SPAN`` when none is open or in a backward pass."""
    trace = _forward_trace()
    return NO_SPAN if trace is None else _Span(trace, name, None)


def trace_count(name: str, inc) -> None:
    """Count ``inc`` under ``name`` in the open device trace, for the step
    of its innermost open span; nothing when no trace is open or in a
    backward pass."""
    trace = _forward_trace()
    if trace is not None:
        trace.count(name, inc)


class MetricsRecorder:
    """Typed per-run metrics: counters, gauges, spans, events, variance.

    Counters are monotone totals (``comm_bytes``, ``permutes``,
    ``program_applications``) billed at dispatch time; gauges are
    point-in-time scalars; ``round`` and ``bucket`` spans time a step and
    a bucket's dispatch; events record discrete occurrences; variance
    records stream the DBench Fig-5 signal.  ``span`` marks a layer of a
    step for ``device_trace``, in memory only.
    """

    def __init__(self, *, sinks=(), metrics_every: int = 0, record_spans: bool = False):
        self.sinks = list(sinks)
        self.metrics_every = max(int(metrics_every), 0)
        self.record_spans = bool(record_spans)
        self.deadline_ms: Optional[float] = None   # set by the engine (configure)
        self.device: Optional[torch.device] = None  # the trainer's (configure)
        self._trace: Optional[_SpanTrace] = None    # the open device trace
        self._events = _EventPool()
        self._rounds: deque = deque()   # event-timed rounds not read yet
        # this run's measured round durations (ms) and deadline overruns
        self.round_ms: list = []
        self.deadline_overruns = 0
        # totals carried across a --resume (load_state_dict)
        self._rounds_prior = 0
        self._overruns_prior = 0
        self.totals: dict[str, float] = {}
        self.last_gauges: dict[str, Optional[float]] = {}
        self.last_variance: Optional[dict] = None
        self.event_count = 0

    # -- wiring ----------------------------------------------------------------
    def configure(self, *, deadline_ms: Optional[float] = None, device=None) -> None:
        """Late configuration by the engine: the deadline rides on the fault
        model, which the recorder's creator does not see; the trainer's
        device decides what clock spans and rounds read."""
        if deadline_ms is not None:
            self.deadline_ms = float(deadline_ms)
        if device is not None:
            self.device = torch.device(device)

    @property
    def active(self) -> bool:
        """True when records fan out to sinks (telemetry requested)."""
        return bool(self.sinks)

    @property
    def timing(self) -> bool:
        """True when ``round`` spans are measured: with a deadline, or with
        sinks and ``record_spans``."""
        return self.deadline_ms is not None or (self.active and self.record_spans)

    @property
    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    @property
    def rounds_total(self) -> int:
        return self._rounds_prior + len(self.round_ms)

    @property
    def overruns_total(self) -> int:
        return self._overruns_prior + self.deadline_overruns

    def _emit(self, rec: dict) -> None:
        if not self.sinks:
            return
        validate_record(rec)
        for s in self.sinks:
            s.emit(rec)

    def close(self) -> None:
        self._read_rounds(keep=0)
        for s in self.sinks:
            close = getattr(s, "close", None)
            if close is not None:
                close()

    # -- manifest ----------------------------------------------------------------
    def manifest(self, run: dict) -> None:
        self._emit({"kind": "manifest", "schema": SCHEMA_VERSION, "run": run})

    # -- counters ----------------------------------------------------------------
    def counter(self, name: str, inc, *, step: int) -> None:
        total = self.totals.get(name, 0) + inc
        self.totals[name] = total
        self._emit({"kind": "counter", "step": int(step), "name": name,
                    "inc": inc, "total": total})

    def comm(self, program, param_bytes: int, *, step: int, alive=None,
             link_up=None) -> None:
        """Bill one program application at dispatch time: bytes on the wire
        (``program_comm_bytes``, the accounting the reference's
        ``benchmarks/ada.py`` replays offline; under faults the surviving
        edges of the realization's ``alive``/``link_up`` only) and the
        PPermute dispatch count."""
        if program is None or not self.active:
            return
        from repro_torch.core.schedule import PPermute, program_comm_bytes

        bytes_ = program_comm_bytes(program, int(param_bytes), alive=alive, link_up=link_up)
        step = int(step)
        self.counter("comm_bytes", int(bytes_), step=step)
        permutes = sum(1 for op in program.ops if isinstance(op, PPermute))
        if permutes:
            self.counter("permutes", permutes, step=step)
        self.counter("program_applications", 1, step=step)

    # -- gauges ----------------------------------------------------------------
    def gauge(self, name: str, value, *, step: int) -> None:
        value = None if value is None else float(value)
        self.last_gauges[name] = value
        self._emit({"kind": "gauge", "step": int(step), "name": name,
                    "value": value})

    # -- spans ----------------------------------------------------------------
    def span(self, name: str, *, step: Optional[int] = None):
        """A context marking one layer of a step.  Off (no ``device_trace``
        open) it is ``NO_SPAN``, whatever the name; on, a span of the trace
        whose step is ``step``, or its parent's."""
        trace = self._trace
        return NO_SPAN if trace is None else _Span(trace, name, step)

    @contextmanager
    def device_trace(self):
        """Record every ``span`` opened inside the context, and every
        ``trace_span`` and ``trace_count`` of the process.  Yields a
        ``TraceRecords`` list that holds the span records once the context
        has closed (after one synchronize; see ``_SpanTrace.resolve``), in
        the order the spans opened, and the counts."""
        if self._trace is not None or _OPEN:
            raise RuntimeError("a device trace is already open")
        trace = _SpanTrace(self._events if self._cuda else None, self.device)
        records = TraceRecords()
        records.counts = trace.counts
        self._trace = trace
        _OPEN.append(trace)
        try:
            yield records
        finally:
            self._trace = None
            _OPEN.clear()
            records.extend(trace.resolve())

    def round_start(self):
        """What opens a ``round`` span: None when timing is off, a CUDA
        event recorded now where the trainer's rounds are event-timed
        (``record_spans`` on a CUDA device, no deadline; the rounds earlier
        steps left are read first, as far as they have run), else the host
        clock."""
        if not self.timing:
            return None
        if self.deadline_ms is None and self._cuda:
            self._read_rounds(keep=ROUND_LAG)
            return self._events.mark()
        return time.perf_counter()

    def round_end(self, t_start, *, step: int, mix: bool = False, device=None) -> None:
        """Close a ``round`` span.  An event-timed round records its end
        event and is read by a later ``round_start`` (or ``close``); else,
        on a CUDA ``device`` (or each of a list of them: a split
        simulator's cards) it synchronizes the device first, so the
        duration covers the whole dispatched round.  With ``t_start`` None
        (timing off) it does nothing."""
        if t_start is None:
            return
        if not isinstance(t_start, float):
            self._rounds.append((t_start, self._events.mark(), int(step), bool(mix)))
            return
        for d in device if isinstance(device, (list, tuple)) else [device]:
            if d is not None and torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)
        self._round_done((time.perf_counter() - t_start) * 1e3, step, mix)

    def _read_rounds(self, *, keep: int) -> None:
        """Read the event-timed rounds, oldest first: each whose end event
        has run, and while more than ``keep`` are left, the oldest waited
        for."""
        while self._rounds:
            start, end, step, mix = self._rounds[0]
            if not end.query():
                if len(self._rounds) <= keep:
                    return
                end.synchronize()
            self._rounds.popleft()
            self._round_done(start.elapsed_time(end), step, mix)
            self._events.give(start, end)

    def _round_done(self, ms: float, step: int, mix: bool) -> None:
        self.round_ms.append(ms)
        rec = {"kind": "span", "step": int(step), "name": "round", "ms": ms,
               "mix": bool(mix)}
        if self.deadline_ms is not None:
            overrun = ms > float(self.deadline_ms)
            self.deadline_overruns += int(overrun)
            rec["deadline_ms"] = float(self.deadline_ms)
            rec["overrun"] = overrun
        self._emit(rec)

    def bucket_span(self, t_start: Optional[float], *, step: int,
                    index: int) -> None:
        """Close a per-bucket ``bucket`` span: host *dispatch* wall-clock
        (no extra blocking — a per-bucket sync would serialize exactly the
        overlap the bucketed path exists to create)."""
        if t_start is None:
            return
        ms = (time.perf_counter() - t_start) * 1e3
        self._emit({"kind": "span", "step": int(step), "name": "bucket",
                    "ms": ms, "index": int(index)})

    def span_start(self) -> Optional[float]:
        """Timestamp for a non-round span; None when sinks are off or span
        timing was not requested."""
        return (
            time.perf_counter() if self.active and self.record_spans else None
        )

    # -- events ----------------------------------------------------------------
    def event(self, name: str, step: int, *, data: Optional[dict] = None) -> None:
        self.event_count += 1
        rec: dict = {"kind": "event", "step": int(step), "name": name}
        if data is not None:
            rec["data"] = data
        self._emit(rec)

    # -- streamed DBench variance ------------------------------------------------
    def due(self, step: int) -> bool:
        """True when ``step`` is a metrics emission step (``--metrics-every``
        cadence).  Engines gate the host transfer of loss/norms on this, so
        disabled telemetry never forces a synchronization."""
        return (
            self.active
            and self.metrics_every > 0
            and int(step) % self.metrics_every == 0
        )

    def step_metrics(self, step: int, *, loss=None, lr=None,
                     norms=None, grads=None) -> None:
        """Emit one metrics sample: loss/lr gauges, the streamed DBench
        ``variance_report`` over the (n_nodes, n_leaves) norm matrix the
        step already computed on the device (kernel K3), and, where the
        bucketed path hands over its gradient buffer, the global gradient
        norm.  Each device value is read once, here."""
        step = int(step)
        if loss is not None:
            loss = torch.as_tensor(loss).detach().cpu().numpy()
            self.gauge("loss", float(np.mean(loss)), step=step)
        if lr is not None:
            self.gauge("lr", float(lr), step=step)
        if grads is not None:
            self.gauge("grad_norm", host_grad_norm(grads), step=step)
        if norms is not None:
            a = torch.as_tensor(norms).detach().cpu().numpy()
            if a.ndim == 2 and a.shape[1] > 0:
                self.variance(step, a)

    def variance(self, step: int, norms) -> None:
        """The paper's Fig-5 signal as a live metric: ``variance_report``
        (gini, CV, index-of-dispersion, quartile coefficient) over the
        (n_nodes, n_leaves) pre-mixing parameter-norm matrix — numerically
        identical to the offline ``DBenchRecorder`` computation because it
        IS the same function on the same array."""
        from repro_torch.core.dbench import variance_report

        report = variance_report(norms)
        metrics, per_layer = {}, {}
        for name, per_leaf in report.items():
            arr = np.asarray(per_leaf, dtype=np.float64)
            mean = float(np.mean(arr)) if arr.size else None
            metrics[name] = (
                mean if mean is not None and np.isfinite(mean) else None
            )
            per_layer[name] = [
                float(v) if np.isfinite(v) else None for v in arr
            ]
        self.last_variance = {"step": int(step), "metrics": metrics}
        self._emit({"kind": "variance", "step": int(step),
                    "metrics": metrics, "per_layer": per_layer})

    # -- resume ----------------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable run totals for the checkpoint's ``extra``
        payload: a resumed run continues its counters and span/overrun
        totals instead of restarting them at zero."""
        self._read_rounds(keep=0)
        return {
            "schema": SCHEMA_VERSION,
            "counters": dict(self.totals),
            "rounds": self.rounds_total,
            "overruns": self.overruns_total,
            "events": int(self.event_count),
        }

    def load_state_dict(self, d: dict) -> None:
        self.totals.update(d.get("counters") or {})
        self._rounds_prior = int(d.get("rounds", 0))
        self._overruns_prior = int(d.get("overruns", 0))
        self.event_count += int(d.get("events", 0))
