"""Port parity: the static-analysis pipeline (``src/repro_torch/analysis``),
mirroring ``tests/test_analysis.py`` case for case where the case applies.

Clean paths plus the seeded mutation suite: for every pass a deliberately
corrupted artifact (a non-stochastic row, colliding and swapped permute
pairs, overlapping segments, non-monotonic bounds, a dtype run off its
leaf, diverging signatures, an all-gather leak, an unbounded dispatch
loop, an oversized K4 shared-memory request, G > 65535, a shape-driven
table build, stray and vacuous program keys) must be CAUGHT.  The
reference's verifier runs on the same programs where both have them.

The reference's f8 wire-width and ``CollectiveReport`` cases run against
the port's op accounting (``launch/hlo_analysis.py``), with its FLOP
counts of every ``-reduced`` gradient step held to the reference's
``analyze_hlo``; the bench-payload gate waits with the benchmarks (not
ported this round).
"""
import dataclasses
import importlib
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import _torch_rank_worker as worker  # noqa: E402
from repro.analysis.invariants import verify_program as jverify_program  # noqa: E402
from repro.core.graphs import from_adjacency as jfrom_adjacency  # noqa: E402
from repro.core.schedule import compile_graph as jcompile_graph  # noqa: E402
from repro_torch.analysis import budget  # noqa: E402
from repro_torch.analysis.budget import (  # noqa: E402
    check_kernel_budget, k4_smem_bytes, verify_kernel_attributes, verify_program_budget,
)
from repro_torch.analysis.collectives import (  # noqa: E402
    assert_signatures_consistent, collective_signature, lint_dispatch_loops,
    lint_engine_sources, lint_no_forbidden,
)
from repro_torch.analysis.invariants import (  # noqa: E402
    verify_bucket_layout, verify_degraded, verify_program, verify_topology,
)
from repro_torch.analysis.recompile import (  # noqa: E402
    assert_executables_preenumerated, assert_no_retrace, note, used_program_keys,
    watch_retrace,
)
from repro_torch.analysis.report import (  # noqa: E402
    BudgetViolation, CollectiveViolation, InvariantViolation, PassReport, RetraceError,
    run_pass,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.buckets import BucketLayout  # noqa: E402
from repro_torch.core.dsgd import make_topology  # noqa: E402
from repro_torch.core.faults import make_fault_model  # noqa: E402
from repro_torch.core.graphs import Ring, Star, from_adjacency  # noqa: E402
from repro_torch.core.schedule import compile_graph, dense_program  # noqa: E402
from repro_torch.core.simulator import DecentralizedSimulator  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import gossip_update as gu  # noqa: E402
from repro_torch.kernels import stats  # noqa: E402
from repro_torch.launch.comm import CollectiveOp, spawn_world  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
fa = importlib.import_module("repro_torch.kernels.flash_attention")


def _quad_loss(p, b):
    return ((b["b"] - p["w"]) ** 2).mean()


def _random_edges(n, seed):
    rng = np.random.default_rng(seed)
    edges = set()
    perm = rng.permutation(n)
    for a, b in zip(perm[:-1], perm[1:]):
        edges.add((min(a, b), max(a, b)))
    for _ in range(int(rng.integers(0, n))):
        i, j = rng.integers(0, n, size=2)
        if i != j:
            edges.add((min(i, j), max(i, j)))
    return sorted((int(i), int(j)) for i, j in edges)


# ---------------------------------------------------------------------------
# Pass 1 — program verifier: clean path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo_name", ["d_ring", "d_star", "d_one_peer_exp"])
def test_verifier_accepts_registered_families(topo_name):
    topo = make_topology(topo_name, 8)
    assert verify_topology(topo, n_epochs=2) >= 1


def test_verifier_accepts_degraded_and_elastic_realizations():
    fm = make_fault_model("dropout", 8, rate=0.3, seed=3, spare_ranks=2)
    topo = make_topology("d_ring", 8, fault_model=fm)
    verify_topology(topo, n_epochs=1, fault_steps=12)


def test_verifier_returns_the_reference_matrix():
    """The port's verifier passes the programs the reference's passes, and
    returns the same W."""
    edges = _random_edges(9, 4)
    np.testing.assert_allclose(verify_program(compile_graph(from_adjacency(edges))),
                               jverify_program(jcompile_graph(jfrom_adjacency(edges))),
                               atol=1e-12)


# ---------------------------------------------------------------------------
# Pass 1 — mutation suite
# ---------------------------------------------------------------------------

def test_mutation_non_stochastic_row_is_caught():
    prog = compile_graph(Ring(8))
    bad = dataclasses.replace(prog, self_weight=0.9)  # rows now sum to > 1
    with pytest.raises(InvariantViolation, match="row .* sums"):
        verify_program(bad)


def test_mutation_colliding_permute_pair_is_caught():
    prog = compile_graph(Ring(8))
    op = prog.ops[0]
    perm = list(op.perm)
    s0, _ = perm[0]
    _, d1 = perm[1]
    perm[0] = (s0, d1)  # two sends now land on one receiver
    bad_op = dataclasses.replace(op, perm=tuple(perm), offset=None)
    bad = dataclasses.replace(prog, ops=(bad_op,) + prog.ops[1:])
    with pytest.raises(InvariantViolation, match="duplicate destination"):
        verify_program(bad)


def test_mutation_swapped_pair_breaks_offset_contract():
    prog = compile_graph(Ring(8))
    op = prog.ops[0]
    assert op.offset is not None  # ring compiles to circulant shifts
    perm = list(op.perm)
    (s0, d0), (s1, d1) = perm[0], perm[1]
    perm[0], perm[1] = (s0, d1), (s1, d0)  # still a bijection, wrong shift
    bad_op = dataclasses.replace(op, perm=tuple(perm))
    bad = dataclasses.replace(prog, ops=(bad_op,) + prog.ops[1:])
    with pytest.raises(InvariantViolation, match="offset"):
        verify_program(bad)


def test_mutation_overlapping_bucket_segments_are_caught():
    layout = BucketLayout((1000, 24, 1000), 256)
    verify_bucket_layout(layout, sizes=(1000, 24, 1000))  # clean first
    segs = [list(b) for b in layout.segments]
    li, start, stop = segs[1][0]
    segs[1][0] = (li, max(0, start - 16), stop)  # overlaps bucket 0's tail
    object.__setattr__(layout, "_segments", tuple(tuple(b) for b in segs))
    with pytest.raises(InvariantViolation):
        verify_bucket_layout(layout, sizes=(1000, 24, 1000))


def test_mutation_non_monotonic_bounds_are_caught():
    layout = BucketLayout((512, 512), 256)
    bounds = list(layout.bounds)
    bounds[1], bounds[2] = bounds[2], bounds[1]
    object.__setattr__(layout, "_bounds", bounds)
    with pytest.raises(InvariantViolation, match="increasing"):
        verify_bucket_layout(layout)


def test_mutation_dtype_run_off_its_leaf_is_caught():
    """A mixed state's bucket step rounds the columns of its narrow runs:
    a run that ends 8 columns past its bfloat16 leaf would round float32
    columns."""
    bf, f32 = torch.bfloat16, torch.float32
    sizes, dtypes = (1000, 24, 1000), (bf, f32, bf)
    layout = BucketLayout(sizes, 256)
    verify_bucket_layout(layout, sizes=sizes, dtypes=dtypes)   # clean first
    runs = layout.dtype_runs(dtypes)
    bad = [list(r) for r in runs]
    k = next(i for i, r in enumerate(runs) if len(r) > 1)
    (a, e, dt), (a2, e2, dt2) = bad[k][0], bad[k][1]
    bad[k][0], bad[k][1] = (a, e + 8, dt), (a2 + 8, e2, dt2)
    object.__setattr__(layout, "dtype_runs", lambda d: tuple(tuple(r) for r in bad))
    with pytest.raises(InvariantViolation, match="run as torch.bfloat16"):
        verify_bucket_layout(layout, sizes=sizes, dtypes=dtypes)


# ---------------------------------------------------------------------------
# Pass 1 — property tests: degraded realizations on random connected graphs
# ---------------------------------------------------------------------------

@given(st.integers(min_value=0, max_value=10_000), st.integers(min_value=4, max_value=10))
@settings(max_examples=25, deadline=None)
def test_degraded_matrix_always_verifies(seed, n):
    prog = compile_graph(from_adjacency(_random_edges(n, seed)))
    rng = np.random.default_rng(seed + 1)
    alive = rng.random(n) > 0.35
    link = rng.random((n, n)) > 0.2
    link = np.asarray(link & link.T) | np.eye(n, dtype=bool)
    verify_program(prog)
    verify_degraded(prog, alive)
    verify_degraded(prog, alive, link)


@given(st.integers(min_value=0, max_value=10_000))
@settings(max_examples=10, deadline=None)
def test_drain_boost_realizations_verify(seed):
    n = 8
    prog = compile_graph(from_adjacency(_random_edges(n, seed)))
    boost = np.ones(n)
    boost[int(np.random.default_rng(seed).integers(n))] = 1.5
    verify_degraded(prog, boost)


# ---------------------------------------------------------------------------
# Pass 2 — collective linter over Comm's op record
# ---------------------------------------------------------------------------

_PERMUTE = [CollectiveOp("permute", ((0, 1), (1, 0)), 256)]
_PERMUTE_SWAPPED = [CollectiveOp("permute", ((0, 1), (1, 2)), 256)]
_GATHER = [CollectiveOp("permute", ((0, 1), (1, 0)), 256), CollectiveOp("all_gather", (), 256)]


def test_collective_signature_reads_rendezvous_identity():
    sig = collective_signature(_PERMUTE)
    assert sig == (("permute", ((0, 1), (1, 0)), 256),)


def test_comm_records_every_collective_in_order(tmp_path):
    """Two gloo ranks: ``Comm.recording`` sees each collective once, with
    its pairs and this rank's bytes; no record before or after."""
    rows = spawn_world(worker.comm_record, 2, (), timeout=120, device="cpu", workdir=tmp_path)
    for before, after, ops in rows:
        assert before is None and after is None
        assert ops == [("permute", ((0, 1), (1, 0)), 24), ("pmean", (), 24),
                       ("all_gather", (), 24), ("gather_host", (), 24),
                       ("scatter_host", (), 24)]


def test_mutation_diverging_signatures_are_caught():
    assert_signatures_consistent({"a": collective_signature(_PERMUTE),
                                  "b": collective_signature(_PERMUTE)})
    with pytest.raises(CollectiveViolation, match="diverge"):
        assert_signatures_consistent({
            "masked": collective_signature(_PERMUTE),
            "unmasked": collective_signature(_PERMUTE_SWAPPED),
        })


def test_mutation_all_gather_leak_is_caught_with_op_name():
    assert lint_no_forbidden(_PERMUTE) == {"permute": 1}   # clean path
    with pytest.raises(CollectiveViolation, match="op 1: all_gather"):
        lint_no_forbidden(_GATHER)


_UNBOUNDED_LOOP_SRC = """\
def dispatch(layout, fn, parts):
    out = []
    for b, w in enumerate(layout.widths):
        out.append(fn(parts[b], w))
    return out
"""

_BOUNDED_LOOP_SRC = """\
import collections, torch

def dispatch(layout, fn, parts):
    out, window = [], collections.deque()
    for b, w in enumerate(layout.widths):
        if len(window) >= MAX_INFLIGHT_BUCKETS:
            window.popleft().wait()
        r = fn(parts[b], w)
        window.append(r)
        out.append(r)
    return out
"""

_HOST_SEGMENT_SRC = """\
def slice_up(layout, leaves):
    out = []
    for segs in layout.segments:
        out.append([leaves[li][a:b] for li, a, b in segs])
    return out
"""


def test_mutation_unbounded_dispatch_loop_is_caught():
    findings = lint_dispatch_loops(_UNBOUNDED_LOOP_SRC, "fake.py")
    assert len(findings) == 1 and "MAX_INFLIGHT_BUCKETS" in findings[0].message
    assert lint_dispatch_loops(_BOUNDED_LOOP_SRC, "fake.py") == []
    assert lint_dispatch_loops(_HOST_SEGMENT_SRC, "fake.py") == []


def test_engine_dispatch_sources_are_bounded():
    assert lint_engine_sources() == []


# ---------------------------------------------------------------------------
# Pass 3 — the rebuild guard
# ---------------------------------------------------------------------------

def test_assert_no_retrace_catches_shape_driven_table_build():
    stats._tiles((0, 8, 16), torch.device("cpu"))   # warm
    with assert_no_retrace("warm shape"):
        stats._tiles((0, 8, 16), torch.device("cpu"))
    with pytest.raises(RetraceError, match="mid-run rebuild"):
        with assert_no_retrace("mutated shape"):
            stats._tiles((0, 8, 24), torch.device("cpu"))   # a new segment table


def test_watch_retrace_counts_and_allowances():
    prog = compile_graph(Ring(5))
    with watch_retrace() as counted:
        gu._device_tables(prog, torch.device("cpu"))
        note("builds")
        note("programs")
    assert (counted.builds, counted.tables, counted.programs) == (1, 1, 1)
    assert not counted.clean
    with assert_no_retrace("declared warm-up", allow=2):
        gu._device_tables(compile_graph(Ring(7)), torch.device("cpu"))
        note("builds")


def test_preenumeration_rejects_stray_and_vacuous_caches():
    topo = make_topology("d_ring", 4)
    allowed_key = topo.distinct_programs()[0][1].cache_key
    fake = types.SimpleNamespace(
        _step_cache={(allowed_key, "faulty"): None, ("__local__", 4): None}, topology=topo)
    assert assert_executables_preenumerated(fake) == {allowed_key}
    fake._step_cache[("rogue", 4, "deadbeef")] = None
    with pytest.raises(RetraceError, match="beyond the pre-enumerated"):
        assert_executables_preenumerated(fake)
    empty = types.SimpleNamespace(_step_cache={}, topology=topo)
    with pytest.raises(RetraceError, match="vacuous"):
        assert_executables_preenumerated(empty)
    assert assert_executables_preenumerated(empty, require_used=False) == set()


def test_used_program_keys_unwraps_engine_taxonomy():
    key = ("d_ring", 8, "abc")
    cache = {
        key: 1,                                     # bare program
        (key, "faulty"): 1,                         # fault signature
        ("__bucket__", key, True, False): 1,        # bucketed step
        ("__local__", 8): 1,                        # local step
        (("__local__", 8), "faulty"): 1,
        "__bucket_grads__": 1,
        None: 1,                                    # the trainer's programless step
    }
    assert used_program_keys(cache) == {key}


def test_simulator_debug_mode_runs_clean():
    topo = make_topology("d_ring", 4)
    sim = DecentralizedSimulator(_quad_loss, sgd(momentum=0.9), topo, debug_no_retrace=True,
                                 device="cpu")
    state = sim.init({"w": torch.zeros(3)})
    rng = np.random.default_rng(0)
    for _ in range(4):   # warm + guarded steady state: must not raise
        b = {"b": rng.normal(size=(4, 2, 3)).astype(np.float32)}
        state, *_ = sim.train_step(state, b, 0.05)
    assert assert_executables_preenumerated(sim) == {topo.distinct_programs()[0][1].cache_key}


def _reduced_trainer(topology, **kw):
    cfg = dataclasses.replace(get_config("granite-8b-reduced"), n_layers=1, remat=False)
    return cfg, SPMDTrainer(cfg, topology, sgd(momentum=0.9), debug_no_retrace=True,
                            device="cpu", **kw)


@pytest.mark.parametrize("bucket_mb", [None, 0.05])
def test_trainer_debug_mode_runs_clean_and_catches_a_rebuild(bucket_mb):
    """SPMDTrainer(debug_no_retrace=True): a time-varying program under a
    crash with a rejoin, fused, 6 steps, none raising; its program keys
    pre-enumerated; then a warm step that rebuilds K1's device tables (the
    cache cleared) raises ``RetraceError``."""
    fm = make_fault_model("crash", 4, rate=0.5, seed=2, down_steps=1)
    cfg, trainer = _reduced_trainer(make_topology("d_one_peer_exp", 4, fault_model=fm),
                                    fused_apply=True, bucket_mb=bucket_mb)
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=8, seed=0)
    for t in range(6):
        state, _, _ = trainer.train_step(state, src.stacked(4, t, 1), 0.05)
    used = assert_executables_preenumerated(trainer)
    assert len(used) >= 2
    gu._device_tables.cache_clear()
    with pytest.raises(RetraceError, match="device table"):
        trainer.train_step(state, src.stacked(4, 6, 1), 0.05)


# ---------------------------------------------------------------------------
# Pass 4 — Hopper launch budgets
# ---------------------------------------------------------------------------

def test_budget_accepts_the_main_path_launches():
    k1 = check_kernel_budget("gossip_program_update", rows=4, cols=838_881_280, deg=2,
                             aligned=True)
    assert k1["grid"] == (4096, 4) and k1["threads"] == 256 and k1["aligned"]
    assert check_kernel_budget("gossip_update", cols=9, deg=2, aligned=False)["grid"] == (1, 1)
    k4 = check_kernel_budget("flash_attention", dtype="bfloat16", b=4, h=32, sq=4096, d=128)
    assert k4["smem_bytes"] == 5 * 128 * 128 * 2 + 64 + 1024 <= budget.SMEM_OPTIN_BYTES
    assert k4_smem_bytes("float32", 128) == 4 * (192 * 132 + 64 * 68)


def test_mutation_oversized_k4_shared_memory_is_caught(monkeypatch):
    """A K/V ring of 4 stages at D = 128 asks for 296,000 B > 227 KiB."""
    monkeypatch.setattr(budget, "K4_BF16_STAGES", 4)
    check_kernel_budget.cache_clear()
    try:
        with pytest.raises(BudgetViolation, match="shared memory"):
            check_kernel_budget("flash_attention", dtype="bfloat16", b=1, h=1, sq=128, d=128)
    finally:
        check_kernel_budget.cache_clear()


def test_mutation_grid_y_over_65535_is_caught():
    with pytest.raises(BudgetViolation, match="grid"):
        check_kernel_budget("gossip_program_update", rows=65536, cols=8, deg=2, aligned=True)
    with pytest.raises(BudgetViolation, match="grid"):
        check_kernel_budget("segment_l2_norms", rows=65536, offsets=(0, 8), aligned=True)
    with pytest.raises(BudgetViolation, match="grid"):
        check_kernel_budget("flash_attention", dtype="float32", b=1, h=65536, sq=64, d=32)


def test_budget_guard_is_wired_into_kernel_dispatch(monkeypatch):
    """Each dispatch entry point raises before its (CPU twin's) work on a
    launch the card would refuse (K2's grid has one row: no shape it takes
    reaches a limit, so a refusing guard stands in for the check)."""
    g = 65536
    theta = torch.zeros(g, 8)
    srcs = torch.zeros(g, 1, dtype=torch.int32)
    w = torch.ones(g, 2)
    with pytest.raises(BudgetViolation, match="grid"):
        gu.gossip_program_update(theta, theta.clone(), srcs, w, theta.clone(), theta.clone(),
                                 lr=0.1, beta=0.9, fault=w.clone())
    with pytest.raises(BudgetViolation, match="grid"):
        stats.segment_l2_norms(theta, (0, 8))
    q = torch.zeros(1, g, 1, 32)
    with pytest.raises(BudgetViolation, match="grid"):
        fa.flash_attention(q, q[:, :1].clone(), q[:, :1].clone(), causal=False)
    seen = []

    def refuse(kernel, **dims):
        seen.append((kernel, dims))
        raise BudgetViolation(f"{kernel} refused")

    monkeypatch.setattr(gu, "check_kernel_budget", refuse)
    row = torch.zeros(8)
    with pytest.raises(BudgetViolation, match="gossip_update refused"):
        gu.gossip_update(row, torch.zeros(1, 8), torch.ones(2), row.clone(), row.clone(),
                         lr=0.1, beta=0.9, fault=torch.ones(2))
    assert seen == [("gossip_update", {"cols": 8, "deg": 1, "aligned": True})]


def test_program_budget_covers_tables_and_skips_dense():
    ring = compile_graph(Ring(8))
    assert verify_program_budget(ring)["grid"] == (512, 8)
    assert not verify_program_budget(ring, cols=7)["aligned"]
    assert verify_program_budget(dense_program(Star(8))) is None


def test_mutation_kernel_attributes_over_budget_are_caught():
    """What the built kernels report, held to the card's limits (the card's
    numbers are read in chip_smoke.py phase 33)."""
    ok = {"regs_per_thread": 40, "static_smem_bytes": 0, "dynamic_smem_bytes": 0,
          "max_threads_per_block": 256, "threads": 256, "local_bytes_per_thread": 0}
    k4 = dict(ok, regs_per_thread=168, threads=384, max_threads_per_block=384,
              dynamic_smem_bytes=k4_smem_bytes("bfloat16", 128))
    verify_kernel_attributes({"gossip_program_update bfloat16": ok,
                              "flash_attention bfloat16 D=128": k4})
    for bad in ({"k1": dict(ok, regs_per_thread=256)},
                {"k1": dict(ok, static_smem_bytes=50_000)},
                {"flash_attention bfloat16 D=128": dict(k4, dynamic_smem_bytes=1)}):
        with pytest.raises(BudgetViolation):
            verify_kernel_attributes(bad)


# ---------------------------------------------------------------------------
# Report plumbing and the CLI
# ---------------------------------------------------------------------------

def test_run_pass_collects_findings_per_subject():
    def boom():
        raise InvariantViolation("synthetic")

    report = run_pass("invariants", [("good", lambda: None), ("bad", boom)])
    assert report.checked == 2 and not report.ok
    assert [f.subject for f in report.findings] == ["bad"]
    with pytest.raises(AssertionError, match="synthetic"):
        report.raise_if_failed()
    clean = PassReport("x", checked=3)
    assert clean.ok and "ok" in clean.summary()


def test_cli_all_passes_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--all", "--device",
                          "cpu"], capture_output=True, text=True, timeout=600, env=env,
                         cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    for name in ("invariants", "collectives", "recompile", "budget", "telemetry-schema"):
        assert f"{name}: " in out.stdout and "FAIL" not in out.stdout


# ---------------------------------------------------------------------------
# The op accounting (launch/hlo_analysis.py): FLOPs, loops, dtype widths,
# collectives
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.hlo_analysis import _dtype_width as jdtype_width  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.common import abstract_params as jabstract  # noqa: E402
from repro_torch.core.schedule import program_comm_bytes  # noqa: E402
from repro_torch.launch.comm import RecordingComm  # noqa: E402
from repro_torch.launch.hlo_analysis import (  # noqa: E402
    CollectiveReport, _dtype_width, analyze_step, assert_no_all_gather, collective_counts,
)
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import abstract_params  # noqa: E402

# rwkv6 and zamba2 count fewer gradient FLOPs than the reference: the
# backward of their chunked recurrences.  XLA's transposition of the
# reference's ``lax.scan`` over chunks and the port's autograd over its
# Python chunk loop arrange the chunk products' gradients differently (the
# forwards are exact, see test_torch_roofline.py; the gap is per layer and
# batch row and grows with the chunk length, not the chunk count).  The
# measured ratios, port / reference at B 2, S 64, chunk 8:
_GRAD_RATIO = {("rwkv6-1.6b", False): 1211498496 / 1214513152,
               ("rwkv6-1.6b", True): 1582825472 / 1585840128,
               ("zamba2-7b", False): 2528182272 / 2533687296,
               ("zamba2-7b", True): 3104047104 / 3109552128}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_gradient_dot_flops_equal_the_reference_hlo(arch):
    """loss_fn + backward of every -reduced arch, remat off and on: exact
    for the attention family, rwkv6 and zamba2 within 0.5 % at the ratio
    measured above."""
    b, s = 2, 64
    for remat in (False, True):
        jcfg = dataclasses.replace(jget_config(arch + "-reduced"), remat=remat)
        tcfg = dataclasses.replace(get_config(arch + "-reduced"), remat=remat)
        tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
        jbatch = {"tokens": tok, "targets": tok}
        tbatch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
                  for k in ("tokens", "targets")}
        if jcfg.input_kind == "vlm":
            jbatch["patch_embeds"] = jax.ShapeDtypeStruct(
                (b, jcfg.n_patches, jcfg.d_model), jnp.float32)
            tbatch["patch_embeds"] = torch.empty((b, tcfg.n_patches, tcfg.d_model),
                                                 device="meta")
        grad = jax.jit(jax.grad(lambda p, x: jtfm.loss_fn(p, jcfg, x)))
        ref = analyze_hlo(grad.lower(jabstract(jtfm.model_defs(jcfg, 1)), jbatch)
                          .compile().as_text())["dot_flops"]
        params = abstract_params(ttfm.model_defs(tcfg))

        def step():
            leaves = {k: v.requires_grad_() for k, v in params.items()}
            return torch.autograd.grad(ttfm.loss_fn(leaves, tcfg, tbatch), list(leaves.values()))

        got = analyze_step(step)["dot_flops"]
        if (arch, remat) in _GRAD_RATIO:
            assert got / ref == pytest.approx(_GRAD_RATIO[arch, remat], rel=0, abs=1e-12)
            assert abs(got / ref - 1) < 5e-3
        else:
            assert got == ref, (arch, remat)


def test_python_loop_bills_every_trip():
    """The eager form of tests/test_perf_features.py's trip-count cases: a
    loop of k matmuls bills k × 2·32³ (the reference's scan of k steps,
    read from its HLO), nested loops multiply."""
    def chain(k):
        def run():
            c, w = torch.ones(32, 32), torch.ones(32, 32)
            for _ in range(k):
                c = c @ w
            return c
        return run

    def jscan(k):
        body = lambda c, _: (c @ jnp.ones((32, 32)), None)
        f = jax.jit(lambda x: jax.lax.scan(body, x, None, length=k)[0])
        return analyze_hlo(f.lower(jnp.ones((32, 32))).compile().as_text())["dot_flops"]

    for k in (4, 8):
        got = analyze_step(chain(k))
        assert got["dot_flops"] == k * 2 * 32 ** 3 == jscan(k)
        assert got["traffic_bytes"] > 0 and got["total_wire_bytes"] == 0

    def nested():
        c, w = torch.ones(16, 16), torch.ones(16, 16)
        for _ in range(5):
            for _ in range(3):
                c = c @ w
        return c

    assert analyze_step(nested)["dot_flops"] == 15 * 2 * 16 ** 3


def test_traffic_counts_moved_bytes_and_skips_views():
    x = torch.ones(64, 32)
    info = analyze_step(lambda: (x.view(32, 64).t(), x.reshape(2048)[:5], x + 1))
    assert info["traffic_bytes"] == 2 * x.numel() * 4     # the add: x in, the sum out
    assert info["op_traffic"] == {"aten.add": 2 * x.numel() * 4}
    assert info["peak_temp_bytes"] == x.numel() * 4


def test_f8_dtype_widths_and_fallback():
    """tests/test_analysis.py's widths, and torch's float8 dtypes."""
    for dt in ("f8e4m3", "f8e4m3fn", "f8e5m2", "f8e4m3fnuz", "f8e5m2fnuz", "f8e8m0fnu",
               "s4", "bf16", "u64", "pred"):
        assert _dtype_width(dt) == jdtype_width(dt), dt
    assert _dtype_width("f8e8m0fnu") == 1 and _dtype_width("s4") == 1
    for name in ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz",
                 "float8_e8m0fnu"):
        dt = getattr(torch, name, None)
        assert _dtype_width(dt if dt is not None else name) == 1, name
    assert _dtype_width("float8_e3m7xyz") == 1            # unknown variant: bit width
    assert (_dtype_width(torch.bfloat16), _dtype_width(torch.float32),
            _dtype_width(torch.bool), _dtype_width(torch.int64)) == (2, 4, 1, 8)


def _sent_bytes(ops, rank, world):
    """Bytes rank ``rank`` puts on the wire for an op record, in
    program_comm_bytes' model: a permute its operand once for each pair it
    sends in, a ring all-reduce 2·(n−1)/n of its operand, an all-gather
    (n−1) operands."""
    total = 0.0
    for op in ops:
        if op.kind == "permute":
            total += op.nbytes * sum(1 for s, _ in op.pairs if s == rank)
        elif op.kind == "pmean":
            total += 2 * op.nbytes * (world - 1) / world
        elif op.kind == "all_gather":
            total += op.nbytes * (world - 1)
    return total


def test_recorded_wire_bytes_equal_program_comm_bytes():
    """Every program of the analysis subjects, each rank of its world run
    on a RecordingComm: the mean bytes a node sends equal
    program_comm_bytes, and the step's collectives are counted."""
    from repro_torch.analysis.__main__ import _distinct_programs

    p = 6
    for label, prog in _distinct_programs().items():
        n = prog.n
        total = 0.0
        for rank in range(n):
            comm = RecordingComm(rank, n, "cpu")
            with comm.recording() as ops:
                info = analyze_step(prog.apply_shard, torch.zeros(p), comm)
            total += _sent_bytes(ops, rank, n)
            assert collective_counts(info).total == len(ops), label
        assert int(total / n) == program_comm_bytes(prog, p * 4), label


def test_assert_no_all_gather_names_the_op():
    x = torch.zeros(4)
    ring = compile_graph(Ring(4))
    report = assert_no_all_gather(ring.apply_shard, x, RecordingComm(1, 4, "cpu"))
    assert isinstance(report, CollectiveReport)
    assert report["collective-permute"] == report.total == 2
    assert report.wire_bytes["collective-permute"] == 2 * 16
    dense = dense_program(Star(4))
    with pytest.raises(AssertionError, match=r"all_gather:0"):
        assert_no_all_gather(dense.apply_shard, x, RecordingComm(1, 4, "cpu"))
    info = analyze_step(dense.apply_shard, x, RecordingComm(1, 4, "cpu"))
    assert info["wire_bytes"] == {"all-gather": 4 * 16}     # the result of 4 rows
    assert collective_counts(info).offending(("all-gather",)) == {
        "all-gather": ("all_gather:0",)}
    pmean = [CollectiveOp("pmean", (), 16)]
    assert collective_counts(pmean).wire_bytes == {"all-reduce": 32}   # 2× on the wire


# ---------------------------------------------------------------------------
# The bench payload gate and the recorder's provenance stamp
# (``tests/test_analysis.py`` and ``tests/test_telemetry.py``'s cases)
# ---------------------------------------------------------------------------

def test_bench_payload_gate():
    from repro_torch.analysis.invariants import verify_bench_payload

    verify_bench_payload("step_time", {"ring/n8": {"mean_ms": 1.0}})
    with pytest.raises(InvariantViolation, match="non-empty dict"):
        verify_bench_payload("step_time", [])
    with pytest.raises(InvariantViolation, match="not a dict"):
        verify_bench_payload("step_time", {"ring/n8": 3.0})
    with pytest.raises(InvariantViolation, match="key"):
        verify_bench_payload("step_time", {"ring n8!": {"mean_ms": 1.0}})
    with pytest.raises(InvariantViolation, match="JSON"):
        verify_bench_payload("step_time", {"ring/n8": {"x": float("nan")}})
    with pytest.raises(InvariantViolation, match="section name"):
        verify_bench_payload("", {"ring/n8": {"mean_ms": 1.0}})


def test_bench_payload_provenance_validation():
    from repro_torch.analysis.invariants import verify_bench_payload
    from repro_torch.telemetry import MemorySink, MetricsRecorder

    rec = MetricsRecorder(sinks=[MemorySink()])
    rec.counter("comm_bytes", 42, step=0)
    prov = rec.provenance()
    assert prov["counters"] == {"comm_bytes": 42.0} and prov["source"] == "telemetry"
    verify_bench_payload("ada", {"d_ring/n8": {"acc": 1.0, "provenance": prov}})
    for broken in (
        {**prov, "source": "handwritten"},
        {**prov, "schema": "one"},
        {**prov, "counters": {"comm_bytes": "lots"}},
        {**prov, "counters": {"comm_bytes": True}},
        {**prov, "rounds": None},
        {**prov, "events": 1.5},
        "not-a-dict",
    ):
        with pytest.raises(InvariantViolation, match="provenance"):
            verify_bench_payload("ada", {"d_ring/n8": {"acc": 1.0, "provenance": broken}})


def test_provenance_stamps_pass_each_others_gate():
    """The port's stamp passes the reference's gate and the reference's
    stamp the port's, from recorders fed the same counters, spans and
    events; the two stamps are equal."""
    from repro.analysis.invariants import InvariantViolation as JViolation
    from repro.analysis.invariants import verify_bench_payload as jverify
    from repro.telemetry import MemorySink as JSink
    from repro.telemetry import MetricsRecorder as JRecorder
    from repro_torch.analysis.invariants import verify_bench_payload as tverify
    from repro_torch.telemetry import MemorySink, MetricsRecorder

    stamps = []
    for rec in (JRecorder(sinks=[JSink()]), MetricsRecorder(sinks=[MemorySink()])):
        rec.counter("comm_bytes", 4096, step=0)
        rec.counter("permutes", 2, step=0)
        rec.event("join", 1, data={"nodes": [3]})
        rec.round_end(rec.round_start(), step=0, mix=True)
        stamps.append(rec.provenance())
    jstamp, tstamp = stamps
    assert jstamp == tstamp
    tverify("ada", {"d_ring/n8": {"acc": 1.0, "provenance": jstamp}})
    jverify("ada", {"d_ring/n8": {"acc": 1.0, "provenance": tstamp}})
    broken = {**tstamp, "rounds": "three"}
    with pytest.raises(JViolation, match="provenance"):
        jverify("ada", {"d_ring/n8": {"provenance": broken}})
    with pytest.raises(InvariantViolation, match="provenance"):
        tverify("ada", {"d_ring/n8": {"provenance": broken}})
