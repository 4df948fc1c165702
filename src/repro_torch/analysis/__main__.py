"""``python -m repro_torch.analysis`` — the static-analysis pipeline: the
counterpart of ``python -m repro.analysis``.

Runs the passes over every program the reference's subjects can emit
(N = 8; d_ring, d_star, d_one_peer_exp and d_random_matching × fault-free,
dropout, link, crash, concurrent, preempt, deadline, join and spare-rank
realizations):

  --invariants   the mixing-program verifier (stochasticity, permute
                 tables, ghost-rank identity, fusion round conservation,
                 bucket-layout coverage and the dtype runs of a mixed state)
  --collectives  the collective linter over ``Comm``'s op record: each
                 program's ``apply_shard`` and ``apply_shard_masked`` on 8
                 spawned ranks (the same sequence on every rank and in both
                 realizations, no all-gather for a colorable graph), and the
                 dispatch-loop lint of the engine sources
  --recompile    the rebuild guard: simulator runs under
                 ``assert_no_retrace`` after warm-up, every program key
                 pre-enumerated
  --budget       K1-K4 launch budgets on Hopper; on the card also the built
                 kernels' registers and shared memory and the card's limits
  --telemetry    a 2-node run streams every record kind through the schema,
                 its summary renders, and a telemetry-on run keys the same
                 programs, builds the same tables and launches the same
                 kernels as a telemetry-off run

``--all`` runs everything.  The passes run on the card unless ``--device
cpu`` is given.  Exit status 1 when any pass reports findings.
"""
from __future__ import annotations

import argparse
import sys

N = 8
TOPOS = ("d_ring", "d_star", "d_one_peer_exp", "d_random_matching")


def _fault_variants():
    """(label, builder) for every fault realization family at n = N: each
    subject constructs its own seeded model."""
    from repro_torch.core.faults import make_fault_model as mk

    return [
        ("fault-free", lambda: None),
        ("dropout", lambda: mk("dropout", N, rate=0.3, seed=3)),
        ("link", lambda: mk("link", N, rate=0.3, seed=4)),
        ("crash", lambda: mk("crash", N, rate=0.5, seed=1, down_steps=6)),
        ("concurrent", lambda: mk("concurrent", N, rate=0.7, seed=1, k=2)),
        ("preempt", lambda: mk("preempt", N, rate=0.6, seed=2, drain_steps=3)),
        ("deadline", lambda: mk("deadline", N, rate=0.4, seed=5)),
        ("join", lambda: mk("join", N, join_steps=(4,))),
        ("spares", lambda: mk("dropout", N, rate=0.3, seed=6, spare_ranks=2)),
    ]


def _distinct_programs():
    """label -> program: every distinct program of the subjects' topologies
    over two epochs."""
    from repro_torch.core.dsgd import make_topology

    out, seen = {}, set()
    for topo_name in TOPOS:
        for _, prog in make_topology(topo_name, N).distinct_programs(2):
            if prog.cache_key not in seen:
                seen.add(prog.cache_key)
                out[f"{topo_name}:{prog.name}"] = prog
    return out


def run_invariants(device):
    import torch

    from repro_torch.analysis.invariants import verify_bucket_layout, verify_topology
    from repro_torch.analysis.report import run_pass
    from repro_torch.core.buckets import BucketLayout
    from repro_torch.core.dsgd import make_topology

    subjects = []
    for topo_name in TOPOS:
        for fault_label, build in _fault_variants():
            def thunk(topo_name=topo_name, build=build):
                topo = make_topology(topo_name, N, fault_model=build())
                verify_topology(topo, n_epochs=2, fault_steps=24)

            subjects.append((f"{topo_name} × {fault_label}", thunk))
    bf, f32 = torch.bfloat16, torch.float32
    for label, sizes, elems, dtypes in [
        ("layout multi-leaf", (3072, 1024, 7), 512, None),
        ("layout straddle", (1000, 24, 1000), 256, None),
        ("layout exact", (512, 512), 512, None),
        ("layout single", (5,), 1 << 20, None),
        ("layout empty", (), 512, None),
        ("layout mixed straddle", (1000, 24, 1000, 3), 256, (bf, f32, bf, f32)),
        ("layout mixed exact", (512, 512, 256), 512, (bf, bf, f32)),
    ]:
        subjects.append((label, lambda s=sizes, e=elems, d=dtypes: verify_bucket_layout(
            BucketLayout(s, e), sizes=s, dtypes=d)))
    return run_pass("invariants", subjects)


def run_collectives(device):
    from repro_torch.analysis.collectives import (
        assert_signatures_consistent, collective_signature, lint_engine_sources,
        lint_no_forbidden, record_programs,
    )
    from repro_torch.analysis.report import CollectiveViolation, run_pass
    from repro_torch.launch.comm import spawn_world

    programs = _distinct_programs()
    ranks = spawn_world(record_programs, N, (programs,), timeout=600,
                        device="cpu" if device.type == "cpu" else None)
    subjects = []
    for label in programs:
        def thunk(label=label):
            rec = [r[label] for r in ranks]
            if any(r != rec[0] for r in rec[1:]):
                raise CollectiveViolation(f"{label}: the ranks recorded different sequences")
            if rec[0]["colorable"]:
                # masking must not change the permute schedule, and neither
                # realization may all-gather on the hot path
                assert_signatures_consistent({k: collective_signature(rec[0][k]) for k in
                                              ("apply_shard", "apply_shard_masked")})
                for k in ("apply_shard", "apply_shard_masked"):
                    lint_no_forbidden(rec[0][k])

        subjects.append((label, thunk))
    report = run_pass("collectives", subjects)
    report.checked += 1
    report.findings.extend(lint_engine_sources())
    return report


def _quad_loss(p, b):
    return ((b["b"] - p["w"]) ** 2).mean()


def _drive(device, topo_name, fault_model, steps, *, telemetry=None, n=N, warm=None):
    """The simulator with a quadratic loss for ``steps`` steps (seeded
    batches); after ``warm`` steps (when given) the rest run under
    ``assert_no_retrace``.  Returns the simulator."""
    import numpy as np
    import torch

    from repro_torch.analysis.recompile import assert_no_retrace
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.optim.sgd import sgd

    topo = make_topology(topo_name, n, fault_model=fault_model)
    sim = DecentralizedSimulator(_quad_loss, sgd(momentum=0.9), topo, collect_norms=True,
                                 telemetry=telemetry, device=device)
    state = sim.init({"w": torch.zeros(4)})
    r = np.random.default_rng(0)
    batches = [r.normal(size=(n, 2, 4)).astype(np.float32) for _ in range(steps)]
    for t in range(steps if warm is None else warm):
        state, *_ = sim.train_step(state, {"b": batches[t]}, 0.05)
    if warm is not None:
        with assert_no_retrace(f"{topo_name} steps {warm}..{steps - 1}"):
            for t in range(warm, steps):
                state, *_ = sim.train_step(state, {"b": batches[t]}, 0.05)
    return sim


def run_recompile(device):
    from repro_torch.analysis.recompile import assert_executables_preenumerated
    from repro_torch.analysis.report import run_pass
    from repro_torch.core.faults import make_fault_model

    def drive(topo_name, fault_model, warm):
        sim = _drive(device, topo_name, fault_model, warm + 8, warm=warm)
        assert_executables_preenumerated(sim, n_epochs=2)

    # the crash's onset and rejoin derive from the seed: warm-up covers
    # every (program, faulty) key, so the guarded window must build nothing
    crash = make_fault_model("crash", N, rate=0.5, seed=1, down_steps=4)
    crash_warm = (crash.rejoin_step or 0) + 2 * N
    subjects = [
        ("d_ring fault-free", lambda: drive("d_ring", None, 4)),
        ("d_one_peer_exp fault-free", lambda: drive("d_one_peer_exp", None, 8)),
        ("d_ring crash+rejoin", lambda: drive(
            "d_ring", make_fault_model("crash", N, rate=0.5, seed=1, down_steps=4),
            crash_warm)),
    ]
    return run_pass("recompile", subjects)


def run_budget(device):
    from repro_torch.analysis import budget
    from repro_torch.analysis.report import BudgetViolation, run_pass

    subjects = []
    for label, prog in _distinct_programs().items():
        for cols in (1 << 20, 838_881_280, 7):
            subjects.append((f"{label} [P={cols}]",
                             lambda p=prog, c=cols: budget.verify_program_budget(p, cols=c)))
    subjects.append(("K2 deg ≤ 8", lambda: [
        budget.check_kernel_budget("gossip_update", cols=838_881_280, deg=d, aligned=True)
        for d in range(9)]))
    subjects.append(("K3 granite-8b leaves", lambda: budget.check_kernel_budget(
        "segment_l2_norms", rows=4, offsets=(0, 201_326_592, 838_881_280), aligned=True)))
    for dtype in ("float32", "bfloat16"):
        for d in budget.K4_HEAD_DIMS:
            subjects.append((f"K4 {dtype} D={d}", lambda dt=dtype, d=d: budget.check_kernel_budget(
                "flash_attention", dtype=dt, b=4, h=32, sq=32768, d=d)))
    if device.type == "cuda":
        def card():
            import torch

            props = torch.cuda.get_device_properties(device)
            limits = budget.device_limits()
            want = {"max_grid_x": budget.MAX_GRID_X, "max_grid_y": budget.MAX_GRID_YZ,
                    "max_grid_z": budget.MAX_GRID_YZ,
                    "smem_optin_bytes": budget.SMEM_OPTIN_BYTES,
                    "smem_bytes": budget.SMEM_STATIC_BYTES,
                    "max_threads_per_block": budget.MAX_THREADS_PER_BLOCK,
                    "regs_per_block": budget.REGS_PER_BLOCK}
            optin = getattr(props, "shared_memory_per_block_optin", limits["smem_optin_bytes"])
            if limits != want or optin != budget.SMEM_OPTIN_BYTES:
                raise BudgetViolation(f"{props.name}: limits {limits} (opt-in {optin}) are not "
                                      f"the budget's {budget.CARD} {want}")
            budget.verify_kernel_attributes(budget.kernel_attributes())

        subjects.append(("the card's limits and the built kernels", card))
    return run_pass("budget", subjects)


def run_telemetry(device):
    from repro_torch.analysis.recompile import watch_retrace
    from repro_torch.analysis.report import AnalysisViolation, run_pass
    from repro_torch.kernels import ops
    from repro_torch.telemetry import MemorySink, MetricsRecorder
    from repro_torch.telemetry.schema import SchemaError, validate_record
    from repro_torch.telemetry.summarize import render_summary, summarize

    def smoke():
        sink = MemorySink()
        rec = MetricsRecorder(sinks=[sink], metrics_every=1, record_spans=True)
        rec.manifest({"engine": "simulator", "n": 2})
        _drive(device, "d_ring", None, 6, telemetry=rec, n=2)
        for r in sink.records:
            validate_record(r)
        missing = {"manifest", "counter", "gauge", "span", "variance"} - {
            r["kind"] for r in sink.records}
        if missing:
            raise AnalysisViolation(f"smoke run missing record kinds: {missing}")
        out = render_summary(summarize([dict(r) for r in sink.records]))
        if "comm MiB" not in out or "per-layer variance" not in out:
            raise AnalysisViolation(f"summary lacks its sections:\n{out}")

    def run(telemetry):
        ops.reset_launch_counts()
        with watch_retrace("telemetry parity") as stats:
            sim = _drive(device, "d_ring", None, 6, telemetry=telemetry, n=2)
        return sorted(map(str, sim._step_cache)), ops.launch_counts(), stats.tables

    def parity():
        run(None)   # warm: the first run builds the probe's tables
        off = run(None)
        on = run(MetricsRecorder(sinks=[MemorySink()], metrics_every=1, record_spans=True))
        if on != off:
            raise AnalysisViolation(f"telemetry changed the run: keys, launches, tables "
                                    f"{off} -> {on}")

    def rejects():
        for bad in (
            {"kind": "nope"},
            {"kind": "counter", "step": 0, "name": "x", "inc": 1},
            {"kind": "gauge", "step": 0, "name": "xi", "value": 1.0, "extra": 2},
        ):
            try:
                validate_record(bad)
            except SchemaError:
                continue
            raise AnalysisViolation(f"schema accepted malformed record {bad!r}")

    return run_pass("telemetry-schema", [
        ("2-node smoke run + stream validation", smoke),
        ("program keys, launches and tables on/off", parity),
        ("malformed records rejected", rejects),
    ])


PASSES = {
    "invariants": run_invariants,
    "collectives": run_collectives,
    "recompile": run_recompile,
    "budget": run_budget,
    "telemetry": run_telemetry,
}


def main(argv=None, device=None) -> int:
    """Run the selected passes (all by default) and print each report;
    returns 1 when any pass reports findings."""
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="static-analysis passes over the port's gossip stack")
    ap.add_argument("--all", action="store_true", help="run every pass")
    for name in PASSES:
        ap.add_argument(f"--{name}", action="store_true")
    ap.add_argument("--device", default=None, help="cpu, or the current card by default")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    selected = [n for n in PASSES if getattr(args, n)]
    if args.all or not selected:
        selected = list(PASSES)
    failed = False
    for name in selected:
        report = PASSES[name](dev)
        print(report.summary())
        for f in report.findings:
            print(f"  {f}")
        failed = failed or not report.ok
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
