"""The traced stretch of a ``--trace 1`` run: steps under
``torch.profiler`` (CPU and CUDA activities), reduced in memory to what the
per-layer metrics read.  Nothing is written to disk.

Each kernel is given to the step whose host span launched it (through the
profiler's link of a kernel to the host op that launched it); the first
profiled step only leads in and is not counted.  The device's busy time
is the union of every device operation's interval inside the window (from
the first counted step's start on the host to the synchronize after the
last), so overlapping kernels count once.  The profiler records every host
op too, which slows the host's dispatch 2.5-2.7 x, so the window's idle
share (``window_s`` − ``busy_s``) is partly the tracer's own.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import numpy as np

from perfbench.yardstick import kernel_group

__all__ = ["profile_steps", "summarize", "STEP", "WINDOW"]

STEP = "perfbench.step"
WINDOW = "perfbench.window"


def profile_steps(step_fn, n: int):
    """Run ``step_fn(k)`` for k < n + 1 under the profiler, each inside a
    ``perfbench.step`` range; returns ``summarize``'s dict over steps 1..n."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for k in range(n + 1):
                with record_function(STEP):
                    step_fn(k)
            torch.cuda.synchronize()
    return summarize(prof.events())


def _is_device(e) -> bool:
    return str(e.device_type).split(".")[-1] in ("CUDA", "PrivateUse1")


def _is_annotation(e) -> bool:
    """The harness's own ranges, which the profiler also shows on the
    device's timeline."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name in (STEP, WINDOW)


def summarize(events) -> dict:
    """``events``: the profiler's ``FunctionEvent``s.  Returns ``steps``,
    ``window_s``, ``busy_s``, ``group_ms`` (device ms a step by kernel
    group), ``device_ops`` and ``idle_gaps`` (each at most 10 [name,
    seconds] pairs, the largest first)."""
    host = [e for e in events if not _is_device(e) and not e.is_async]
    device = [e for e in events if _is_device(e) and not _is_annotation(e)]
    steps = sorted((e.time_range.start, e.time_range.end) for e in host if e.name == STEP)
    window = [e for e in host if e.name == WINDOW]
    if len(steps) < 2 or not window:
        raise ValueError("the profiled window holds no counted step")
    lo, hi = steps[1][0], window[0].time_range.end
    starts = [s for s, _ in steps]
    launch = {e.id: e.time_range.start for e in host}

    def step_of(e) -> int:
        link = getattr(e, "linked_correlation_id", 0) or 0
        t = launch.get(link, e.time_range.start) if link > 0 else e.time_range.start
        return bisect.bisect_right(starts, t) - 1

    group_us, op_us = defaultdict(float), defaultdict(float)
    spans = []
    for e in device:
        dur = e.time_range.end - e.time_range.start
        if step_of(e) >= 1:
            group_us[kernel_group(e.name)] += dur
            op_us[e.name[:120]] += dur
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b > a:
            spans.append((a, b))
    n = len(steps) - 1
    busy, gaps = _union(spans, lo, hi)
    return {
        "steps": n,
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "group_ms": {g: us / 1e3 / n for g, us in group_us.items()},
        "device_ops": [[k, v / 1e6] for k, v in
                       sorted(op_us.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": _label_gaps(gaps, host),
    }


def _union(spans, lo: float, hi: float):
    """(busy µs, idle gaps [(start, end)]) of intervals within [lo, hi]."""
    busy, gaps, end = 0.0, [], lo
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def _label_gaps(gaps, host, keep: int = 200) -> list:
    """The idle time of the ``keep`` longest gaps summed by what the host
    was doing at each gap's middle (the innermost host range holding it),
    the 10 largest sums."""
    if not gaps:
        return []
    own = (STEP, WINDOW)
    ranges = [e for e in host if e.name not in own]
    s = np.array([e.time_range.start for e in ranges] or [0.0])
    t = np.array([e.time_range.end for e in ranges] or [0.0])
    by = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:keep]:
        mid = (a + b) / 2
        hold = np.nonzero((s <= mid) & (t >= mid))[0] if ranges else []
        name = ranges[int(hold[np.argmin(t[hold] - s[hold])])].name if len(hold) else "no op on the host"
        by[name[:120]] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]
