"""Two stretches of a ``--trace 1`` run that read the program's own spans
(``MetricsRecorder.span`` in ``repro_torch.telemetry``), and the per-layer
metrics they feed.

(a) The span stretch: steps back to back, profiler off, inside the
    recorder's ``device_trace``.  Each span's device, self and host ms a
    counted step (``fwd_bwd.span_ms``, ``wire.span_ms``,
    ``update_wire.roofline_pct``), and the stretch's step ms, which set
    beside the profiler-off stretch's is what the spans cost when on.
(b) The idle stretch: the same steps under a profiler that records CUDA
    activity and, of the host, only ``record_function`` ranges (the spans'
    ``repro.*`` and the harness's ``perfbench.step``): no aten op is
    recorded, so the host dispatches near its untraced speed.  The
    device's idle share over the counted steps (``step.idle_pct``: from
    the first counted step's start to the last one's end on the host), and
    each idle gap put down to the innermost ``repro.*`` range the host was
    in at the gap's middle (printed as ``idle by span``).  Then, still
    under that profiler and with spans on, ``HOST_STEPS`` steps each
    started on an idle device: the host's dispatch of a step with the
    tracer on, beside ``host.step_ms``'s with it off.

Each stretch runs one lead-in step and ``SPAN_STEPS`` counted steps.  A
program whose recorder has no ``device_trace`` runs neither, and the
readers find nothing.

``cell.py`` does not run these stretches, and ``BENCHMARK.json`` does not
list the four metrics.  This file's command takes ``run.py``'s arguments
and runs a cell as ``run.py`` does, with both stretches after the three of
``cell._traced`` and the four metrics (``METRICS``) after the manifest's
per-layer metrics::

    python3 perfbench/spans.py --workload <name> --seed <n> --seconds <s> --trace 1
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

__all__ = ["SPAN_STEPS", "HOST_STEPS", "PREFIX", "OUTSIDE", "METRICS", "per_step", "span_stretch",
           "idle_stretch", "idle_reduce", "label_by_span", "with_span_stretches", "main"]

SPAN_STEPS = 10
HOST_STEPS = 5
PREFIX = "repro."           # the program's span ranges
OUTSIDE = "outside the step's spans"

# the metrics' manifest entries (``per_layer``)
METRICS = [
    {"name": "fwd_bwd.span_ms", "unit": "ms/step", "better": "lower", "source": "program_span",
     "layer": "per-node forward and backward: core/flat.py node_grads_into over "
              "models/transformer.py, attention.py, mlp.py, moe.py",
     "moves": "tokens_per_s"},
    {"name": "wire.span_ms", "unit": "ms/step", "better": "lower", "source": "program_span",
     "layer": "update and gossip mix: kernels/gossip_update.py (K1 fused_apply_stacked), "
              "core/schedule.py",
     "moves": "tokens_per_s"},
    {"name": "update_wire.roofline_pct", "unit": "%", "better": "higher",
     "source": "program_span",
     "layer": "update and gossip mix: kernels/gossip_update.py (K1 fused_apply_stacked), "
              "core/schedule.py",
     "moves": "tokens_per_s"},
    {"name": "step.idle_pct", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "whole step", "moves": "tokens_per_s"},
]


def per_step(records, n: int) -> dict:
    """Span name -> mean ``device_ms``, ``self_ms`` and ``host_ms`` over
    the last ``n`` steps of ``records`` (a step is a top-level span) and
    how many times it ran in them."""
    steps = {r["step"] for r in [r for r in records if r["parent"] is None][-n:]}
    sums: dict = {}
    for r in records:
        if r["step"] in steps:
            d = sums.setdefault(r["name"], {"device_ms": 0.0, "self_ms": 0.0, "host_ms": 0.0,
                                            "count": 0})
            for k in ("device_ms", "self_ms", "host_ms"):
                d[k] += r[k]
            d["count"] += 1
    return {name: {**{k: d[k] / n for k in ("device_ms", "self_ms", "host_ms")},
                   "count": d["count"]} for name, d in sums.items()}


def span_stretch(step, recorder, clock, n: int = SPAN_STEPS) -> dict:
    """Stretch (a): ``step()`` 1 + ``n`` times back to back inside the
    recorder's device trace; returns the span table of the counted steps
    (``spans``) and their mean step ms between the clock's marks
    (``span_step_ms``)."""
    with recorder.device_trace() as records:
        step()
        a = clock.mark()
        for _ in range(n):
            step()
        b = clock.mark()
    return {"spans": per_step(records, n), "span_step_ms": clock.ms(a, b) / n}


@contextmanager
def _user_ranges_profiler(cuda: bool):
    """A profiler of the device's activity that records, of the host, the
    ``record_function`` ranges alone (``RecordScope.USER_SCOPE``).  The
    public ``torch.profiler`` takes no scope, so the profiler's own enable
    call is given one while it starts."""
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler as ap

    prof = ap.profile(use_device="cuda" if cuda else None, use_kineto=True)
    enable = ap._enable_profiler
    ap._enable_profiler = lambda config, activities, *_a, **_k: enable(
        config, activities, {RecordScope.USER_SCOPE})
    try:
        prof.__enter__()
    finally:
        ap._enable_profiler = enable
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)


def idle_stretch(step, recorder, clock, n: int = SPAN_STEPS) -> dict:
    """Stretch (b): ``step()`` 1 + ``n`` times back to back, each in a
    ``perfbench.step`` range, inside the recorder's device trace and under
    the user-ranges profiler; returns ``idle_reduce`` of its events with
    the span table of the counted steps (``spans``), and the host ms of
    ``HOST_STEPS`` more steps under it, each after a synchronize
    (``host_step_ms``)."""
    from torch.profiler import record_function

    from perfbench.trace import STEP

    clock.sync()
    with _user_ranges_profiler(clock.cuda) as prof:
        with recorder.device_trace() as records:
            for _ in range(n + 1):
                with record_function(STEP):
                    step()
        host_ms = []
        with recorder.device_trace():
            for _ in range(HOST_STEPS):
                clock.sync()
                t = time.perf_counter()
                step()
                host_ms.append((time.perf_counter() - t) * 1e3)
    out = idle_reduce(prof.function_events)
    out.update(spans=per_step(records, n), host_step_ms=host_ms)
    return out


def idle_reduce(events) -> dict:
    """``events``: the idle stretch's ``FunctionEvent``s.  The window runs
    from the first counted ``perfbench.step`` range's start to the last
    one's end (the first range leads in); ``busy_s`` is the union of the
    device operations' intervals inside it, and ``by_span`` its idle gaps
    summed by ``label_by_span``."""
    from perfbench.trace import STEP, _is_annotation, _is_device, _union

    host = [e for e in events if not _is_device(e) and not e.is_async]
    steps = sorted((e.time_range.start, e.time_range.end) for e in host if e.name == STEP)
    if len(steps) < 2:
        raise ValueError("the idle stretch holds no counted step")
    lo, hi = steps[1][0], steps[-1][1]
    busy_spans = []
    for e in events:
        if _is_device(e) and not _is_annotation(e):
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b > a:
                busy_spans.append((a, b))
    busy, gaps = _union(busy_spans, lo, hi)
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in host
              if e.name.startswith(PREFIX)]
    return {"steps": len(steps) - 1, "window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "by_span": label_by_span(gaps, ranges)}


def label_by_span(gaps, ranges) -> list:
    """[name, idle seconds] pairs, the largest first: each gap (start, end
    in µs) summed under the innermost of ``ranges`` ((start, end, name)
    host ranges) that holds its middle, or under ``OUTSIDE``."""
    if not gaps:
        return []
    g = np.asarray(gaps, dtype=np.float64)
    mid, length = g.mean(axis=1), g[:, 1] - g[:, 0]
    names = np.array([r[2] for r in ranges] + [OUTSIDE])
    if ranges:
        s = np.array([r[0] for r in ranges], dtype=np.float64)
        t = np.array([r[1] for r in ranges], dtype=np.float64)
        holds = (s[None, :] <= mid[:, None]) & (t[None, :] >= mid[:, None])
        width = np.where(holds, (t - s)[None, :], np.inf)
        which = np.where(holds.any(axis=1), width.argmin(axis=1), len(ranges))
    else:
        which = np.zeros(len(g), dtype=int)
    by = {}
    for i, us in zip(which, length):
        by[str(names[i])] = by.get(str(names[i]), 0.0) + float(us) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]


def with_span_stretches(traced):
    """``cell._traced`` followed by stretches (a) and (b) on the same
    trainer and batch pool; the trace dict gains ``spans`` and
    ``span_step_ms`` (a) and ``idle`` (b)."""
    from perfbench.cell import _log

    def run(trainer, state, pool, lr, first, clock):
        state, out, losses = traced(trainer, state, pool, lr, first, clock)
        recorder = trainer.telemetry
        if not hasattr(recorder, "device_trace"):
            _log("the program has no device_trace: no span stretches")
            return state, out, losses
        k = first + len(losses)

        def step():
            nonlocal state, k
            state, loss, _n = trainer.train_step(state, pool[k % len(pool)], lr)
            losses.append(loss)
            k += 1

        out.update(span_stretch(step, recorder, clock))
        out["idle"] = idle_stretch(step, recorder, clock)
        fmt = lambda spans: {n: [round(v[f], 3) for f in ("device_ms", "self_ms", "host_ms")]
                             for n, v in spans.items()}
        _log(f"span stretch: step {out['span_step_ms']:.3f} ms (profiler off "
             f"{out['untraced_step_ms']:.3f}); spans [device, self, host] ms a step "
             f"{fmt(out['spans'])}")
        idle = out["idle"]
        _log(f"idle stretch: busy {idle['busy_s']:.6f} s of {idle['window_s']:.6f} s; spans "
             f"{fmt(idle['spans'])}; host ms a step on an idle device "
             f"{np.round(idle['host_step_ms'], 3).tolist()} (profiler off "
             f"{np.round(out['host_step_ms'], 3).tolist()})")
        _log("idle by span " + str({k: round(v, 6) for k, v in idle["by_span"]}))
        return state, out, losses

    return run


def main(argv=None) -> int:
    """``run.py``'s command with the span stretches and their metrics."""
    from perfbench import cell, manifest, run

    cell._traced = with_span_stretches(cell._traced)
    listed = manifest.cell_metrics
    manifest.cell_metrics = lambda man, name, kind: (
        listed(man, name, kind) + (METRICS if kind == "per_layer" else []))
    return run.main(argv)


if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import run as _run  # noqa: F401  (its clock starts at import)

    sys.exit(main())
