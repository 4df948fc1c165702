"""The span stretches (``spans.py``) and the four readers of the program's
spans: nothing to read without the stretches, the right value from
hand-made records, idle gaps put down to the innermost span, and both
stretches through ``run_cell`` on a tiny CPU cell."""
import importlib.util
from types import SimpleNamespace as NS

import pytest

from perfbench import cell, manifest, spans
from perfbench.trace import STEP
from perfbench.yardstick import least_seconds, update_mix_least_bytes

READERS = ["fwd_bwd.span_ms", "wire.span_ms", "update_wire.roofline_pct", "step.idle_pct"]


def _read(name, ctx):
    path = manifest.ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"span_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _ctx(trace):
    return {"trace": trace, "nodes": 4, "params": 1000, "param_bytes": 2000}


def _rec(name, step, parent, device_ms, self_ms=None, host_ms=1.0):
    return {"name": name, "step": step, "parent": parent, "device_ms": device_ms,
            "self_ms": device_ms if self_ms is None else self_ms, "host_ms": host_ms}


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_the_stretches(name):
    assert _read(name, _ctx(None)) is None
    assert _read(name, _ctx({"untraced_step_ms": 130.0, "group_ms": {"other": 9.0}})) is None
    assert _read(name, _ctx({"spans": {}, "idle": None})) is None


def _hand_made_trace():
    records = []
    for step in range(3):    # step 0 leads in, and is not counted
        lead = 100.0 if step == 0 else 0.0
        records += [_rec("train_step", step, None, 130.0 + lead, self_ms=2.0 + lead),
                    _rec("fwd_bwd", step, "train_step", 50.0 + step),
                    _rec("wire", step, "train_step", 60.0),
                    _rec("update_mix", step, "train_step", 18.0 - step)]
    table = spans.per_step(records, 2)
    assert table["fwd_bwd"] == {"device_ms": 51.5, "self_ms": 51.5, "host_ms": 1.0, "count": 2}
    assert table["train_step"]["self_ms"] == 2.0 and table["update_mix"]["device_ms"] == 16.5
    return {"spans": table, "idle": {"busy_s": 0.9, "window_s": 1.2, "by_span": []}}


@pytest.mark.parametrize("name,want", [
    ("fwd_bwd.span_ms", 51.5),
    ("wire.span_ms", 60.0),
    ("update_wire.roofline_pct",
     100.0 * least_seconds(update_mix_least_bytes(4, 1000, 2000)) / (76.5 / 1e3)),
    ("step.idle_pct", 25.0),
])
def test_readers_from_hand_made_records(name, want):
    assert _read(name, _ctx(_hand_made_trace())) == pytest.approx(want)


def test_idle_gaps_go_to_the_innermost_span():
    ranges = [(0, 100, "repro.train_step"), (10, 40, "repro.fwd_bwd"),
              (50, 90, "repro.wire"), (60, 70, "repro.inner")]
    gaps = [(12, 14), (20, 30), (55, 57), (64, 66), (92, 98), (150, 160)]
    got = dict(spans.label_by_span(gaps, ranges))
    assert got == pytest.approx({"repro.fwd_bwd": 12e-6, "repro.wire": 2e-6,
                                 "repro.inner": 2e-6, "repro.train_step": 6e-6,
                                 spans.OUTSIDE: 10e-6})
    assert spans.label_by_span([], ranges) == []
    assert spans.label_by_span([(0, 4)], []) == [[spans.OUTSIDE, pytest.approx(4e-6)]]


def _ev(name, a, b, *, device=False, annotation=False):
    return NS(name=name, time_range=NS(start=a, end=b), is_async=False,
              device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
              is_user_annotation=annotation)


def test_the_idle_window_is_the_counted_steps():
    events = [
        _ev(STEP, 0, 100), _ev(STEP, 100, 300), _ev(STEP, 300, 500),
        _ev("repro.train_step", 100, 290), _ev("repro.wire", 150, 250),
        _ev("repro.train_step", 300, 490),
        _ev(STEP, 100, 300, device=True, annotation=True),      # not device work
        _ev("kernel_a", 50, 160, device=True),                   # the lead-in's, partly in
        _ev("kernel_b", 200, 320, device=True),
        _ev("kernel_c", 400, 600, device=True),                  # runs past the window
    ]
    out = spans.idle_reduce(events)
    assert out["steps"] == 2
    assert out["window_s"] == pytest.approx(400e-6)
    assert out["busy_s"] == pytest.approx((60 + 120 + 100) * 1e-6)
    assert dict(out["by_span"]) == pytest.approx({"repro.wire": 40e-6,
                                                  "repro.train_step": 80e-6})
    with pytest.raises(ValueError, match="no counted step"):
        spans.idle_reduce(events[:1])


def test_a_program_without_device_trace_runs_no_stretch():
    inner = lambda trainer, state, pool, lr, first, clock: (state, {"untraced_step_ms": 1.0}, [])
    trainer = NS(telemetry=NS())
    state, out, losses = spans.with_span_stretches(inner)(trainer, "s", [], 0.1, 3, None)
    assert (state, out, losses) == ("s", {"untraced_step_ms": 1.0}, [])


def test_both_stretches_through_a_cpu_cell(tiny_root, monkeypatch):
    """``run_cell`` with the three stretches of ``_traced`` stood in for
    (they need a card) and the span stretches after them: every counted
    step's layers once, and the four metrics on the result line (on the
    CPU no device operation is recorded, so the idle share is 100 %)."""
    def three(trainer, state, pool, lr, first, clock):
        return state, {"untraced_step_ms": 1.0, "host_step_ms": [1.0], "group_ms": {},
                       "busy_s": 0.0, "window_s": 1.0, "device_ops": [], "idle_gaps": []}, []

    seen = {}

    def keep(inner):
        def run(*a):
            state, out, losses = inner(*a)
            seen.update(out=out, losses=len(losses))
            return state, out, losses
        return run

    monkeypatch.setattr(cell, "_traced", keep(spans.with_span_stretches(three)))
    listed = manifest.cell_metrics
    monkeypatch.setattr(manifest, "cell_metrics", lambda man, name, kind: (
        listed(man, name, kind) + (spans.METRICS if kind == "per_layer" else [])))
    out = cell.run_cell("granite8b-g4-b4x1024", 2**31 + 11, 0.05, True, root=tiny_root,
                        device="cpu", log=lambda _: None)
    assert out["correct"] and out["attempted"] == seen["losses"] == (
        2 * (spans.SPAN_STEPS + 1) + spans.HOST_STEPS)
    for table in (seen["out"]["spans"], seen["out"]["idle"]["spans"]):
        assert {k: v["count"] for k, v in table.items()} == {
            k: spans.SPAN_STEPS for k in ("train_step", "fwd_bwd", "probe", "wire",
                                          "update_mix")}
        step = table["train_step"]
        children = sum(v["device_ms"] for k, v in table.items() if k != "train_step")
        assert step["self_ms"] == pytest.approx(step["device_ms"] - children)
    idle = seen["out"]["idle"]
    assert idle["steps"] == spans.SPAN_STEPS and idle["busy_s"] == 0.0
    assert len(idle["host_step_ms"]) == spans.HOST_STEPS
    assert {k for k, _ in idle["by_span"]} <= {"repro.train_step", "repro.fwd_bwd",
                                              "repro.probe", "repro.wire",
                                              "repro.update_mix", spans.OUTSIDE}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["fwd_bwd.span_ms"] > 0 and m["wire.span_ms"] > 0
    assert m["update_wire.roofline_pct"] > 0 and m["step.idle_pct"] == 100.0
