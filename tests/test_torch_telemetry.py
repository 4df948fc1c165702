"""Port parity: run telemetry (``repro_torch/telemetry``) against the
reference's ``repro/telemetry``.

Mirrors ``tests/test_telemetry.py`` (all but the analysis-backed bench
provenance check):

* the recorder's units: coalescing, counters, the inert recorder (and a
  step under it that reads nothing from the device and opens no span),
  span gating, the schema, the resume totals (``state_dict``/
  ``load_state_dict`` against the reference's); the reference's
  provenance case has no counterpart (the port writes no bench payload);
* spans inside a step (``span``/``device_trace``): the trainer's layers
  once a step under their parents, the numbers bit for bit with spans on
  and off, self time, the profiler's ``repro.*`` ranges, one synchronize a
  trace and event-timed rounds read without one (CUDA events stood in
  for on the CPU);
* the engines: telemetry leaves the numbers alone; comm counters equal the
  offline ``program_comm_bytes`` accounting; the streamed variance equals
  the offline ``DBenchRecorder``; round spans per step;
* the controller's events through one coalescing implementation;
* JSONL round trips through ``summarize``/``diff`` (with a resumed
  segment), a corrupt stream is rejected, and ``python -m
  repro_torch.telemetry summarize`` reads the committed fixture;
* record streams equal the reference's on the same numpy inputs: the
  simulator (monolithic and bucketed, closed loop), the trainer against
  the reference's dense simulator, and a 4-rank gloo world against the
  stacked trainer.  Counters exactly; loss within 5e-5 (or relative, for
  large losses); Ξ, the gradient norm and the variance metrics within
  rtol 1e-5 (plus 1e-6 absolute: the float32 floor of a dispersion of
  nearly equal norms); events equal; spans by name, step and count.  The
  reference's ``read_jsonl``/``diff`` read a port run and the other way
  round.
"""
import dataclasses
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_rank_worker  # noqa: E402
from repro import telemetry as jtel  # noqa: E402
from repro.core.dsgd import make_topology as jmake_topology  # noqa: E402
from repro.core.simulator import DecentralizedSimulator as JSim  # noqa: E402
from repro_torch.core.dbench import DBenchRecorder, variance_report  # noqa: E402
from repro_torch.core.dsgd import make_topology  # noqa: E402
from repro_torch.core.schedule import program_comm_bytes  # noqa: E402
from repro_torch.core.simulator import DecentralizedSimulator  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    NO_SPAN, JsonlSink, MemorySink, MetricsRecorder, coalesce_into, host_grad_norm,
    read_jsonl,
)
from repro_torch.telemetry.schema import (  # noqa: E402
    KINDS, SCHEMA_VERSION, SchemaError, validate_record,
)
from repro_torch.telemetry.summarize import (  # noqa: E402
    diff_summaries, main as cli_main, render_summary, summarize,
)
from test_torch_train import BATCH, G, LR, SEQ, _init  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "telemetry_fixture.jsonl"
jsgd = importlib.import_module("repro.optim.sgd").sgd
jsummarize = importlib.import_module("repro.telemetry.summarize")
tsgd = importlib.import_module("repro_torch.optim.sgd").sgd

N = 4


def _quad_loss(p, b):
    return torch.mean((b["x"] - p["w"]) ** 2)


def _jquad_loss(p, b):
    return jnp.mean((b["x"] - p["w"]) ** 2)


def _batches(n, steps, seed=0):
    """Per-node noisy targets for three steps, then one target for every
    node: the replicas part, then agree, so Ξ rises and falls."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(n, 2, 3)).astype(np.float32) for _ in range(steps)]
    for x in out[3:]:
        x[:] = x[0]
    return [{"x": x} for x in out]


def _run_sim(steps=5, telemetry=None, topo_name="d_ring", n=N, topo_kw=None, **kw):
    topo = make_topology(topo_name, n, **(topo_kw or {}))
    sim = DecentralizedSimulator(_quad_loss, tsgd(momentum=0.9), topo, collect_norms=True,
                                 telemetry=telemetry, device="cpu", **kw)
    state = sim.init({"w": np.zeros(3, np.float32)})
    traces = []
    for b in _batches(n, steps):
        state, loss, norms = sim.train_step(state, b, 0.05)
        traces.append((loss.numpy().copy(), norms.numpy().copy()))
    return sim, state, traces


def _run_jsim(steps, telemetry, topo_name="d_ring", n=N, topo_kw=None, **kw):
    topo = jmake_topology(topo_name, n, **(topo_kw or {}))
    sim = JSim(_jquad_loss, jsgd(momentum=0.9), topo, collect_norms=True, telemetry=telemetry,
               **kw)
    state = sim.init({"w": jnp.zeros(3)})
    for b in _batches(n, steps):
        state, _, _ = sim.train_step(state, {"x": jnp.asarray(b["x"])}, 0.05)
    return sim


def _close(a, b, rtol=1e-5, atol=1e-6):
    if a is None or b is None:
        return a is b
    return abs(a - b) <= atol + rtol * abs(b)


def assert_streams_equal(got, want, *, loss_rel=False):
    """Port records ``got`` against reference records ``want``, manifests
    aside: the same sequence of (kind, name, step); counters exactly;
    gauges and variance within the module's bars; events equal; spans by
    name, step and count."""
    got = [r for r in got if r["kind"] != "manifest"]
    want = [r for r in want if r["kind"] != "manifest"]
    key = lambda r: (r["kind"], r.get("name"), r.get("step"))
    assert [key(r) for r in got] == [key(r) for r in want]
    for g, w in zip(got, want):
        validate_record(g)
        kind, name = g["kind"], g.get("name")
        if kind == "counter":
            assert (g["inc"], g["total"]) == (w["inc"], w["total"]), (g, w)
        elif kind == "gauge" and name == "loss":
            tol = 5e-5 * max(1.0, abs(w["value"])) if loss_rel else 5e-5
            assert abs(g["value"] - w["value"]) <= tol, (g, w)
        elif kind == "gauge" and name == "lr":
            assert g["value"] == w["value"]
        elif kind == "gauge":
            assert _close(g["value"], w["value"], atol=1e-12), (g, w)
        elif kind == "variance":
            assert g["metrics"].keys() == w["metrics"].keys()
            for m in w["metrics"]:
                assert _close(g["metrics"][m], w["metrics"][m]), (m, g, w)
                for a, b in zip(g["per_layer"][m], w["per_layer"][m], strict=True):
                    assert _close(a, b), (m, g["step"])
        elif kind == "event":
            assert g == w
        else:
            assert kind == "span" and g.keys() == w.keys()


# ---------------------------------------------------------------------------
# recorder units
# ---------------------------------------------------------------------------

def test_schema_is_the_reference_schema():
    assert SCHEMA_VERSION == jtel.SCHEMA_VERSION == 1
    assert {k: sorted(v) for k, v in KINDS.items()} == {
        k: sorted(v) for k, v in jtel.KINDS.items()}


def test_coalesce_into_merges_same_step_reasons():
    events = []
    assert coalesce_into(events, 3, "depart") == "depart"
    assert coalesce_into(events, 3, "rejoin") == "depart+rejoin"
    assert coalesce_into(events, 3, "depart") is None  # idempotent re-arm
    assert coalesce_into(events, 4, "depart") == "depart"
    assert events == [(3, "depart+rejoin"), (4, "depart")]


def test_counters_accumulate_and_emit_totals():
    sink = MemorySink()
    rec = MetricsRecorder(sinks=[sink])
    rec.counter("comm_bytes", 10, step=0)
    rec.counter("comm_bytes", 5, step=1)
    assert rec.totals["comm_bytes"] == 15
    assert [r["total"] for r in sink.records] == [10, 15]
    for r in sink.records:
        validate_record(r)


def test_inert_recorder_is_free():
    rec = MetricsRecorder()  # the default every engine constructs
    assert not rec.active and not rec.timing
    assert rec.round_start() is None and rec.span_start() is None
    rec.round_end(None, step=0)  # no-op, no crash
    rec.gauge("loss", 1.0, step=0)
    rec.counter("x", 1, step=0)
    assert not rec.due(0)


@pytest.mark.parametrize("engine", ["simulator", "trainer", "trainer-unbucketed"])
def test_a_step_under_the_inert_recorder_reads_nothing_back(engine, monkeypatch):
    """The CPU's stand-in for chip_smoke.py's sync check: a step of a
    static topology with the default recorder (bucketed, and the trainer's
    fused step without buckets, which marks its layers as spans) calls
    none of the tensor methods that copy a value to the host, and with
    tracing off opens no span: no span object, no profiler range, no
    CUDA event."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.telemetry import recorder

    if engine == "simulator":
        sim = DecentralizedSimulator(_quad_loss, tsgd(0.9), make_topology("d_ring", N),
                                     collect_norms=True, bucket_mb=1e-5, device="cpu")
        state = sim.init({"w": np.zeros(3, np.float32)})
        step = lambda: sim.train_step(state, _batches(N, 1)[0], 0.05)
    else:
        bucket_mb = 0.5 if engine == "trainer" else None
        trainer = SPMDTrainer(get_config("granite-8b-reduced"), make_topology("d_ring", 4),
                              tsgd(0.9), collect_norms=True, fused_apply=True,
                              bucket_mb=bucket_mb, device="cpu")
        state = trainer.init_state(seed=0)
        batch = {k: torch.as_tensor(v)
                 for k, v in SyntheticLM(vocab=256, seq_len=8, seed=0).stacked(4, 0, 1).items()}
        step = lambda: trainer.train_step(state, batch, 0.05)

    def refuse(*a, **k):
        raise AssertionError("a host read or a span under the inert recorder")

    for name in ("item", "tolist", "cpu", "numpy", "__float__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(recorder._Span, "__init__", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    step()


def test_span_timing_gating():
    # sinks alone do NOT turn on per-step syncs (bench safety) …
    assert MetricsRecorder(sinks=[MemorySink()]).round_start() is None
    # … the CLI's record_spans=True does …
    assert MetricsRecorder(sinks=[MemorySink()], record_spans=True).round_start() is not None


def test_state_dict_roundtrip_continues_totals():
    """The reference's case, and the payload equal to the reference
    recorder's after the same records."""
    import json

    recs = []
    for lib in (MetricsRecorder, jtel.MetricsRecorder):
        rec = lib()
        rec.configure(deadline_ms=1.0)
        rec.counter("comm_bytes", 100, step=0)
        rec.event("join", 0)
        rec.round_end(time.perf_counter() - 0.05, step=0)   # 50 ms > 1 ms: an overrun
        recs.append(rec)
    saved = recs[0].state_dict()
    assert saved == recs[1].state_dict()
    json.dumps(saved)  # must ride the checkpoint extra payload
    fresh = MetricsRecorder()
    fresh.configure(deadline_ms=1.0)
    fresh.load_state_dict(saved)
    assert fresh.totals["comm_bytes"] == 100 and fresh.event_count == 1
    assert fresh.rounds_total == 1 and fresh.overruns_total == 1
    assert fresh.round_ms == []  # per-process view restarts
    fresh.round_end(fresh.round_start(), step=1)
    assert fresh.rounds_total == 2 and len(fresh.round_ms) == 1


def test_schema_rejects_malformed_records():
    good = {"kind": "gauge", "step": 0, "name": "xi", "value": 1.0}
    validate_record(good)
    for bad in (
        {"kind": "nope"},
        {"kind": "counter", "step": 0, "name": "x", "inc": 1},  # no total
        {**good, "extra": 1},                         # unknown field
        {**good, "step": "zero"},                     # wrong type
        {"kind": "span", "step": 0, "name": "round"},  # missing ms
    ):
        with pytest.raises(SchemaError):
            validate_record(bad)


def test_host_grad_norm_of_a_flat_buffer(monkeypatch):
    """One float32 sum of squares per column chunk, one host read."""
    from repro_torch.telemetry import recorder

    monkeypatch.setattr(recorder, "GRAD_NORM_CHUNK", 7)   # several chunks
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 30)).astype(np.float32))
    want = float(np.sqrt((g.numpy().astype(np.float64) ** 2).sum()))
    assert host_grad_norm(g) == pytest.approx(want, rel=1e-6)
    assert jtel.host_grad_norm({"a": jnp.asarray(g.numpy())}) == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------

def test_telemetry_leaves_the_numbers_alone():
    _, off, _ = _run_sim(steps=5)
    rec = MetricsRecorder(sinks=[MemorySink()], metrics_every=1, record_spans=True)
    _, on, _ = _run_sim(steps=5, telemetry=rec)
    assert torch.equal(off.theta, on.theta) and torch.equal(off.opt["mom"], on.opt["mom"])


def test_comm_counters_match_offline_accounting():
    rec = MetricsRecorder(sinks=[MemorySink()])
    sim, _, _ = _run_sim(steps=5, telemetry=rec)
    prog = sim.topology.program_at(step=0, epoch=0)
    pbytes = 3 * 4  # {"w": zeros(3)} float32, per node
    assert rec.totals["comm_bytes"] == 5 * program_comm_bytes(prog, pbytes)
    assert rec.totals["program_applications"] == 5
    assert rec.totals["permutes"] == 5 * len(prog.ops)


def test_streamed_variance_equals_offline_dbench():
    sink = MemorySink()
    rec = MetricsRecorder(sinks=[sink], metrics_every=1)
    _, _, traces = _run_sim(steps=5, telemetry=rec)
    offline = DBenchRecorder(impl="ref", n_nodes=N)
    for t, (loss, norms) in enumerate(traces):
        offline.record(t, loss, norms)
    var_recs = [r for r in sink.records if r["kind"] == "variance"]
    assert len(var_recs) == 5
    for t, r in enumerate(var_recs):
        for name, per_leaf in variance_report(offline.norms[t]).items():
            np.testing.assert_allclose(r["per_layer"][name], per_leaf, rtol=1e-12)
            assert r["metrics"][name] == pytest.approx(float(np.mean(per_leaf)))
    gini = offline.metric_series("gini").mean(axis=-1)
    np.testing.assert_allclose([r["metrics"]["gini"] for r in var_recs], gini, rtol=1e-12)


def test_round_spans_one_per_step():
    sink = MemorySink()
    rec = MetricsRecorder(sinks=[sink], record_spans=True)
    _run_sim(steps=5, telemetry=rec, bucket_mb=1e-5)
    rounds = [r for r in sink.records if r["kind"] == "span" and r["name"] == "round"]
    buckets = [r for r in sink.records if r["kind"] == "span" and r["name"] == "bucket"]
    assert [r["step"] for r in rounds] == list(range(5))
    # P = 3 elements in 2-element buckets: two per step
    assert [(r["step"], r["index"]) for r in buckets] == [(s, i) for s in range(5)
                                                          for i in range(2)]


# ---------------------------------------------------------------------------
# spans inside a step
# ---------------------------------------------------------------------------

def test_span_off_is_one_shared_no_op():
    rec = MetricsRecorder(sinks=[MemorySink()], record_spans=True)
    assert rec.span("train_step", step=0) is NO_SPAN and rec.span("wire") is NO_SPAN
    with rec.span("wire"):
        pass
    with rec.device_trace() as spans:
        assert rec.span("wire") is not NO_SPAN
        with pytest.raises(RuntimeError, match="already open"):
            with rec.device_trace():
                pass
    assert spans == [] and rec.span("wire") is NO_SPAN


def test_self_time_is_the_span_less_its_children():
    """Nested spans on the CPU's host clock: parents, the step inherited,
    self ms the span less its children's device ms."""
    rec = MetricsRecorder()
    with rec.device_trace() as spans:
        with rec.span("train_step", step=7):
            time.sleep(0.002)
            with rec.span("fwd_bwd"):
                time.sleep(0.003)
            with rec.span("update_mix"):
                with rec.span("inner"):
                    time.sleep(0.001)
    step, fb, um, inner = spans
    assert [r["name"] for r in spans] == ["train_step", "fwd_bwd", "update_mix", "inner"]
    assert [r["parent"] for r in spans] == [None, "train_step", "train_step", "update_mix"]
    assert {r["step"] for r in spans} == {7}
    assert step["self_ms"] == pytest.approx(
        step["device_ms"] - fb["device_ms"] - um["device_ms"], abs=1e-9)
    assert um["self_ms"] == pytest.approx(um["device_ms"] - inner["device_ms"], abs=1e-9)
    assert fb["self_ms"] == fb["device_ms"] >= 3.0 and step["self_ms"] >= 2.0
    assert all(r["host_ms"] >= r["device_ms"] * 0.99 for r in spans)


def test_spans_are_profiler_ranges():
    rec = MetricsRecorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.device_trace():
            with rec.span("train_step", step=0):
                with rec.span("wire"):
                    torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"repro.train_step", "repro.wire"} <= names


def _span_trainer(**kw):
    from repro_torch.configs import get_config

    topo = kw.pop("topology", "d_ring")
    trainer = SPMDTrainer(get_config("granite-8b-reduced"), make_topology(topo, 4), tsgd(0.9),
                          collect_norms=True, device="cpu", **kw)
    return trainer, trainer.init_state(seed=0)


def _span_batches(steps):
    from repro_torch.data import SyntheticLM

    src = SyntheticLM(vocab=256, seq_len=8, seed=0)
    return [{k: torch.as_tensor(v) for k, v in src.stacked(4, t, 1).items()}
            for t in range(steps)]


SPAN_CASES = {
    # the benchmarked path: stacked, fused, no buckets
    "fused": ({"fused_apply": True}, ["fwd_bwd", "probe", "wire", "update_mix"]),
    "interpreter": ({"fused_apply": False}, ["fwd_bwd", "probe", "update_mix"]),
    "later-rounds": ({"fused_apply": True, "topology": "d_one_peer_exp", "mix_rounds": 2},
                     ["fwd_bwd", "probe", "wire", "update_mix", "later_rounds"]),
}


@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_a_traced_step_records_its_layers_once(case):
    kw, children = SPAN_CASES[case]
    trainer, state = _span_trainer(**kw)
    with trainer.telemetry.device_trace() as spans:
        for b in _span_batches(2):
            state, _, _ = trainer.train_step(state, b, 0.05)
    want = []
    for step in range(2):
        want += [("train_step", step, None)] + [(c, step, "train_step") for c in children]
    assert [(r["name"], r["step"], r["parent"]) for r in spans] == want
    for r in spans:
        assert r["device_ms"] > 0 and r["host_ms"] > 0 and r["self_ms"] >= 0
    again = trainer.train_step(state, _span_batches(1)[0], 0.05)   # off again
    assert again is not None and trainer.telemetry._trace is None


def test_spans_leave_the_numbers_alone():
    """θ, the momentum, the losses and the norms bit for bit with spans on
    and off."""
    out = []
    for traced in (False, True):
        trainer, state = _span_trainer(fused_apply=True)
        got = []
        with trainer.telemetry.device_trace() if traced else NO_SPAN:
            for b in _span_batches(3):
                state, loss, norms = trainer.train_step(state, b, 0.05)
                got += [loss.clone(), norms.clone()]
        out.append([state.theta.clone(), state.mom.clone()] + got)
    for a, b in zip(*out, strict=True):
        assert torch.equal(a, b)


class _FakeEvent:
    """``torch.cuda.Event`` stood in for on the CPU: the host clock, and
    ``query`` false while ``running`` (the device still busy)."""
    made = 0
    running = False
    waited = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return not type(self).running

    def synchronize(self):
        type(self).waited += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_cuda(monkeypatch):
    """A recorder's CUDA path on the CPU: fake events, and a count of
    device synchronizes."""
    syncs = []
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "running", False)
    monkeypatch.setattr(_FakeEvent, "waited", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    return syncs


def test_a_cuda_trace_synchronizes_once_and_reuses_its_events(fake_cuda):
    rec = MetricsRecorder()
    rec.configure(device="cuda")
    made = []
    for _ in range(2):
        with rec.device_trace() as spans:
            for step in range(3):
                with rec.span("train_step", step=step):
                    with rec.span("wire"):
                        pass
        made.append(_FakeEvent.made)
        assert [r["step"] for r in spans] == [0, 0, 1, 1, 2, 2]
    assert len(fake_cuda) == 2            # one synchronize a trace, none a step
    assert made == [12, 12]               # the second trace takes the first's events


def test_rounds_on_cuda_are_read_from_events_without_a_synchronize(fake_cuda):
    """``record_spans`` on a CUDA device: each round's events are read by
    a later step's ``round_start`` once they have run (more than
    ``ROUND_LAG`` unread: the oldest waited for), the rest at ``close``;
    no device synchronize."""
    from repro_torch.telemetry.recorder import ROUND_LAG

    sink = MemorySink()
    rec = MetricsRecorder(sinks=[sink], record_spans=True)
    rec.configure(device="cuda")
    rec.round_end(rec.round_start(), step=0, mix=True)
    _FakeEvent.running = True
    t = rec.round_start()                  # step 0 has not run: left unread
    assert rec.round_ms == [] and sink.records == []
    rec.round_end(t, step=1, mix=True)
    _FakeEvent.running = False
    t = rec.round_start()                  # both have run now
    assert [r["step"] for r in sink.records] == [0, 1] and len(rec.round_ms) == 2
    rec.round_end(t, step=2, mix=False)
    _FakeEvent.running = True
    for step in range(3, 3 + ROUND_LAG + 2):
        rec.round_end(rec.round_start(), step=step, mix=True)
    assert _FakeEvent.waited == 2 and len(rec._rounds) == ROUND_LAG + 1
    assert rec.state_dict()["rounds"] == 3 + ROUND_LAG + 2
    rec.close()
    assert [r["step"] for r in sink.records] == list(range(3 + ROUND_LAG + 2))
    for r in sink.records:
        validate_record(r)
    assert fake_cuda == []
    assert _FakeEvent.made <= 2 * (ROUND_LAG + 3)   # read events go back to the pool


def test_a_deadline_keeps_the_synchronize_on_cuda(fake_cuda):
    rec = MetricsRecorder()
    rec.configure(deadline_ms=1e3, device="cuda")
    for step in range(2):
        t = rec.round_start()
        assert isinstance(t, float)
        rec.round_end(t, step=step, device="cuda")
    assert len(fake_cuda) == 2 and len(rec.round_ms) == 2 and rec.deadline_overruns == 0
    assert _FakeEvent.made == 0


# ---------------------------------------------------------------------------
# controller events: one coalescing implementation for both engines
# ---------------------------------------------------------------------------

def _drive(controller_topo, recorder):
    ctl = controller_topo.controller
    ctl.bind_recorder(recorder)
    ctl.observe(1.0, 0)          # seeds xi0
    ctl.observe(0.4, 1)          # fires: transition to rung 1
    ctl.rearm(3, "depart")       # membership events, same step:
    ctl.rearm(3, "rejoin")       # distinct reasons coalesce …
    ctl.rearm(3, "depart")       # … duplicates are dropped
    ctl.rearm(5, "join")
    return ctl


def test_controller_event_stream_equals_the_reference():
    got, want = MemorySink(), MemorySink()
    ctl = _drive(make_topology("d_ada", 8, k0=6, consensus_target=0.5),
                 MetricsRecorder(sinks=[got]))
    jctl = _drive(jmake_topology("d_ada", 8, k0=6, consensus_target=0.5),
                  jtel.MetricsRecorder(sinks=[want]))
    assert got.records == want.records
    assert ctl.events == jctl.events == [(3, "depart+rejoin"), (5, "join")]
    names = [(r["step"], r["name"], (r.get("data") or {}).get("reason")) for r in got.records]
    assert names == [
        (1, "transition", None),
        (3, "controller", "depart"),
        (3, "controller", "depart+rejoin"),  # re-emitted on merge
        (5, "controller", "join"),
    ]
    out = render_summary(summarize([{"kind": "manifest", "schema": 1, "run": {}}]
                                   + got.records))
    assert "depart+rejoin" in out and out.count("controller") == 2


# ---------------------------------------------------------------------------
# JSONL round trips
# ---------------------------------------------------------------------------

def test_jsonl_resume_roundtrip(tmp_path):
    path = str(tmp_path / "run.jsonl")
    rec = MetricsRecorder(sinks=[JsonlSink(path)], metrics_every=2, record_spans=True)
    rec.manifest({"engine": "simulator", "topology": "d_ring", "n": N})
    _, state, _ = _run_sim(steps=4, telemetry=rec)
    rec.close()

    # resumed segment: a fresh recorder appending to the same stream (no
    # checkpoint restores its totals here, so the counters restart;
    # tests/test_torch_resume.py carries them across a checkpoint)
    rec2 = MetricsRecorder(sinks=[JsonlSink(path, append=True)], metrics_every=2,
                           record_spans=True)
    rec2.manifest({"engine": "simulator", "topology": "d_ring", "n": N, "resumed": True})
    sim2 = DecentralizedSimulator(_quad_loss, tsgd(momentum=0.9), make_topology("d_ring", N),
                                  collect_norms=True, telemetry=rec2, device="cpu")
    state = dataclasses.replace(state, step=4)
    for b in _batches(N, 8)[4:]:
        state, *_ = sim2.train_step(state, b, 0.05)
    rec2.close()
    assert rec2.totals["program_applications"] == 4

    records = read_jsonl(path)
    rounds = [r["step"] for r in records if r["kind"] == "span" and r["name"] == "round"]
    assert rounds == list(range(8))
    s = summarize(records)
    assert s["segments"] == 2 and s["last_step"] == 7
    assert s["counters"]["program_applications"] == 4
    assert "segments: 2 (resumed run)" in render_summary(s)
    assert "last_step" in diff_summaries(s, s, labels=("a", "b"))
    # the reference reads the port's stream, and diffs it against its own
    assert jtel.read_jsonl(path) == records
    ref = str(tmp_path / "ref.jsonl")
    jrec = jtel.MetricsRecorder(sinks=[jtel.JsonlSink(ref)], metrics_every=2)
    _run_jsim(4, jrec)
    jrec.close()
    assert jsummarize.main(["diff", path, ref]) == 0
    assert cli_main(["diff", ref, path]) == 0


def test_read_jsonl_rejects_corrupt_stream(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"kind": "gauge", "step": 0}\n')
    with pytest.raises(SchemaError, match=r":1:"):
        read_jsonl(str(path))


def test_cli_summarize_exits_clean_on_committed_fixture(capsys):
    assert FIXTURE.exists(), "committed fixture missing"
    assert cli_main(["summarize", str(FIXTURE)]) == 0
    out = capsys.readouterr().out
    for needle in ("per-phase step time", "comm MiB", "xi last", "per-layer variance"):
        assert needle in out, f"summary lost its {needle!r} table"
    assert cli_main(["diff", str(FIXTURE), str(FIXTURE)]) == 0
    assert cli_main(["summarize", str(FIXTURE) + ".nope"]) == 1


def test_python_m_summarize_reads_the_fixture():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.telemetry", "summarize",
                          str(FIXTURE)], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "per-phase step time" in out.stdout and "run counters" in out.stdout


# ---------------------------------------------------------------------------
# record streams against the reference's on the same inputs
# ---------------------------------------------------------------------------

SIM_CASES = {
    "d_ring": dict(topo_name="d_ring"),
    "d_ring-bucketed": dict(topo_name="d_ring", bucket_mb=1e-5),
    # closed loop, 8 nodes: a probe per step, a transition at step 8
    "d_ada-closed": dict(topo_name="d_ada", n=8,
                         topo_kw=dict(k_floor="one_peer", consensus_target=0.9)),
    "d_ada-closed-bucketed": dict(topo_name="d_ada", n=8, bucket_mb=1e-5,
                                  topo_kw=dict(k_floor="one_peer", consensus_target=0.9)),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simulator_stream_equals_the_reference(case):
    kw = SIM_CASES[case]
    got, want = MemorySink(), MemorySink()
    _run_sim(steps=12, telemetry=MetricsRecorder(sinks=[got], metrics_every=2,
                                                 record_spans=True), **kw)
    _run_jsim(12, jtel.MetricsRecorder(sinks=[want], metrics_every=2, record_spans=True), **kw)
    assert_streams_equal(got.records, want.records)
    names = {r["name"] for r in got.records if r["kind"] in ("gauge", "event")}
    if "bucketed" in case:
        assert "grad_norm" in names
    if case.startswith("d_ada"):
        assert "transition" in names and "xi" in names


def _trainer_records(topology, topo_kw, engine_kw, steps, metrics_every=2):
    """The port's stacked trainer from the reference's weights (the setup of
    ``tests/test_torch_train.py``) with a ``MemorySink``."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM

    _, params = _init()
    sink = MemorySink()
    rec = MetricsRecorder(sinks=[sink], metrics_every=metrics_every)
    cfg = get_config("granite-8b-reduced")
    trainer = SPMDTrainer(cfg, make_topology(topology, G, **topo_kw), tsgd(0.9),
                          collect_norms=True, telemetry=rec, device="cpu", **engine_kw)
    state = trainer.init_state(params=params_from_jax(params))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    for t in range(steps):
        state, _, _ = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
    return sink.records


def test_trainer_stream_equals_the_reference_simulator():
    """Closed-loop d_ada (``tests/test_torch_train.py``'s case: the handoff
    fires at step 2) through the port's trainer and the reference's dense
    simulator on the same weights and batches."""
    from repro.configs import get_config as jget_config
    from repro.data import SyntheticLM
    from repro.models import transformer as jtfm

    topo_kw = {"k_floor": "one_peer", "consensus_target": 0.9}
    got = _trainer_records("d_ada", topo_kw, {"mix_every": 2}, 4)
    cfg = dataclasses.replace(jget_config("granite-8b-reduced"), dtype=jnp.float32, remat=False)
    _, params = _init()
    sink = jtel.MemorySink()
    sim = JSim(lambda p, b: jtfm.loss_fn(p, cfg, b), jsgd(0.9),
               jmake_topology("d_ada", G, **topo_kw), mixing="dense", collect_norms=True,
               mix_every=2, telemetry=jtel.MetricsRecorder(sinks=[sink], metrics_every=2))
    state = sim.init(jax.tree.map(jnp.asarray, params))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    for t in range(4):
        batch = {k: jnp.asarray(v) for k, v in src.stacked(G, t, BATCH).items()}
        state, _, _ = sim.train_step(state, batch, LR)
    assert_streams_equal(got, sink.records)
    assert any(r["kind"] == "event" and r["name"] == "transition" for r in got)


RANK_CASES = {
    "d_ring-fused-bucketed": ("d_ring", {}, {"fused_apply": True, "bucket_mb": 0.5}),
    "d_ada-closed": ("d_ada", {"k_floor": "one_peer", "consensus_target": 0.9},
                     {"mix_every": 2}),
}


@pytest.fixture(scope="module")
def rank_streams(tmp_path_factory):
    _, params = _init()
    tparams = {k: v.numpy() for k, v in params_from_jax(params).items()}
    return spawn_world(_torch_rank_worker.telemetry_cases, G,
                       (RANK_CASES, tparams, 4, SEQ, BATCH, LR, 2), timeout=120,
                       device="cpu", workdir=tmp_path_factory.mktemp("tel-world"))


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_ranks_stream_equals_the_stacked_stream(rank_streams, case):
    """A 4-rank gloo world writes the stacked trainer's record stream
    (rank 0 alone; the ranks engine keeps the monolithic step under
    ``bucket_mb``, so no gradient-norm gauge on either side there)."""
    topology, topo_kw, engine_kw = RANK_CASES[case]
    assert all(r[case] == [] for r in rank_streams[1:])
    want = _trainer_records(topology, topo_kw, {**engine_kw, "bucket_mb": None}, 4)
    assert_streams_equal(rank_streams[0][case], want)
    assert [r for r in rank_streams[0][case] if r["kind"] == "variance"]
