"""chip_smoke.py's checks run on the CPU at the reduced granite-8b size in
bfloat16: the comparison of the fused and the interpreted training step
(phase 5; phase 14 with multi-round programs) passes the true steps and
fails a step that mixes wrongly; the simulator equals the trainer (phase
13); the paper's configurations run through the simulator (phase 15,
shortened); the bucketed trainer equals the monolithic one and K1 with a
wrong row stride fails (phase 16); the folded probe holds and a bucket
left out of the fold fails (phase 17); run telemetry (phase 18); the fault
runs hold and a K1 that ignores the fault rows fails (phase 19), their
bucketed runs hold and fault rows built per bucket fail (phase 20), the
simulator under faults equals the trainer (phase 21), 4 gloo ranks
under a crash with rejoin equal their stacked rows (phase 22), and the
checkpoint phases hold: the stacked trainer's resume (phase 23; a restore
that loses the controller or the momentum fails), the ranks engine's
(phase 24; a file off phase 4's state fails), the simulator's (phase 25;
a lost controller fails) and the knobs (phase 26; a θ or a loss off its
bar fails the accumulation check)."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dsgd import make_topology  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import gossip_update as gu  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("granite-8b-reduced"), dtype=torch.bfloat16)
    topo = make_topology("d_ring", chip_smoke.G)
    fused = SPMDTrainer(cfg, topo, sgd(momentum=0.9), fused_apply=True, device="cpu")
    plain = SPMDTrainer(cfg, topo, sgd(momentum=0.9), fused_apply=False, device="cpu")
    state = fused.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=16, seed=0)
    batches = [{k: torch.as_tensor(v) for k, v in src.stacked(chip_smoke.G, t, 2).items()}
               for t in range(3)]
    for t in range(2):
        state, _, _ = fused.train_step(state, batches[t], chip_smoke.LR)
    return fused, plain, state, batches[2]


def _rolled_neighbours(orig):
    def run(theta, wire, srcs, *args, **kw):
        return orig(theta, wire, torch.roll(srcs, 1, 0).contiguous(), *args, **kw)
    return run


def _no_neighbours(orig):
    def run(theta, wire, srcs, weights, *args, **kw):
        w = torch.zeros_like(weights)
        w[:, 0] = 1.0
        return orig(theta, wire, srcs, w, *args, **kw)
    return run


@pytest.mark.parametrize("mutant", [None, _rolled_neighbours, _no_neighbours])
def test_phase5_passes_the_true_step_and_fails_a_wrong_mix(setup, mutant, monkeypatch):
    fused, plain, state, batch = setup
    monkeypatch.setattr(chip_smoke, "TWIN_CHUNK", 1000)   # several chunks
    if mutant is None:
        _, ulps, tol_share, rel_m, moved = chip_smoke.phase_fused_vs_interpreter(
            fused, plain, state.clone(), batch)
        assert tol_share <= 1.0 and rel_m == 0.0 and moved > 0.9
        assert ulps <= 2.0
    else:
        monkeypatch.setattr(gu, "gossip_program_update", mutant(gu.gossip_program_update))
        with pytest.raises(SystemExit):
            chip_smoke.phase_fused_vs_interpreter(fused, plain, state.clone(), batch)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 64, True, None), (64, 64, False, None), (64, 64, True, 16),
    (64, 64, False, 16), (96, 40, True, 7), (40, 96, True, None),
    (256, 128, True, 32), (33, 77, False, 100), (50, 50, True, 0),
])
def test_attention_pair_count_matches_brute_force(sq, sk, causal, window):
    """K4's bound counts the (q, k) pairs its mask allows; held against a
    brute-force count of the reference kernel's mask."""
    q = torch.arange(sq)[:, None]
    k = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= k <= q
    if window is not None:
        mask &= k > q - window
    assert chip_smoke.attention_pairs(sq, sk, causal=causal, window=window) == int(mask.sum())


def test_attention_bound_at_granite_prefill():
    """The figures the bound gives at phase 12's shapes (B, H, KV, S, D)."""
    ms, by, flops, nbytes = chip_smoke.attention_bound(4, 32, 8, 4096, 4096, 128, 2,
                                                      causal=True, window=None)
    assert chip_smoke.attention_pairs(4096, 4096, causal=True, window=None) == 8_390_656
    assert flops == 4 * 128 * 4 * 32 * 8_390_656 and nbytes == 335_544_320
    assert by == "operations" and abs(ms - 0.556) < 1e-3
    ms_l, by_l, _, _ = chip_smoke.attention_bound(1, 32, 8, 32768, 32768, 128, 2,
                                                 causal=True, window=None)
    assert by_l == "operations" and abs(ms_l - 8.894) < 1e-3


# ---------------------------------------------------------------------------
# Phases 13-15 on the CPU, at the reduced granite-8b size in bfloat16
# ---------------------------------------------------------------------------

@pytest.fixture
def on_cpu(monkeypatch):
    """chip_smoke's phases on the CPU: CUDA bookkeeping calls do nothing,
    the engines' default device is the CPU, and every call of K1's or K3's
    plain twin counts as a launch of that kernel (the wrapper counts its
    CUDA launches only)."""
    from repro_torch.core import simulator as sim_mod
    from repro_torch.kernels import stats
    from repro_torch.launch import train as train_mod

    for name, value in (("synchronize", lambda *a: None),
                        ("reset_peak_memory_stats", lambda *a: None),
                        ("max_memory_allocated", lambda *a: 0),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    cpu = lambda device=None: torch.device("cpu" if device is None else device)
    monkeypatch.setattr(sim_mod, "resolve_device", cpu)
    monkeypatch.setattr(train_mod, "resolve_device", cpu)

    def counting(twin, wrapper):
        def run(*args, **kw):
            wrapper.launches += 1
            return twin(*args, **kw)
        return run

    monkeypatch.setattr(stats, "segment_l2_norms_plain",
                        counting(stats.segment_l2_norms_plain, stats.segment_l2_norms))
    monkeypatch.setattr(gu, "gossip_program_update_plain",
                        counting(gu.gossip_program_update_plain, gu.gossip_program_update))


def _reduced(steps):
    cfg = dataclasses.replace(get_config("granite-8b-reduced"), dtype=torch.bfloat16)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=16, seed=0)
    batches = [{k: torch.as_tensor(v) for k, v in src.stacked(chip_smoke.G, t, 2).items()}
               for t in range(steps)]
    from repro_torch.core.flat import FlatLayout
    from repro_torch.models import transformer as tfm

    layout = FlatLayout.from_shapes({k: d.shape for k, d in tfm.model_defs(cfg).items()})
    return cfg, layout, batches


def test_phase13_simulator_equals_trainer_on_cpu(on_cpu, monkeypatch):
    cfg, layout, batches = _reduced(chip_smoke.SIM_STEPS)
    monkeypatch.setattr(chip_smoke, "SAMPLE", 64)
    launches, numbers, _, _ = chip_smoke.phase_simulator(cfg, batches,
                                                         chip_smoke.sample_columns(layout))
    assert launches["segment_l2_norms"] == chip_smoke.SIM_STEPS
    # the same arithmetic as the trainer: equal, not merely within the bars
    assert numbers["max_theta_err_bf16_ulps"] == 0.0 and numbers["max_mom_abs_err"] == 0.0


def _skip_later_rounds(orig):
    def run(stages, theta, mix):
        return orig(stages[:0], theta, mix)
    return run


@pytest.mark.parametrize("mutant", [None, "rolled", "later-rounds"])
def test_phase14_passes_true_rounds_and_fails_wrong_ones(on_cpu, monkeypatch, mutant):
    from repro_torch.launch import train as train_mod

    cfg, layout, batches = _reduced(chip_smoke.ADA_STEPS)
    monkeypatch.setattr(chip_smoke, "TWIN_CHUNK", 4096)   # several chunks
    if mutant == "rolled":
        monkeypatch.setattr(gu, "gossip_program_update", _rolled_neighbours(gu.gossip_program_update))
    elif mutant == "later-rounds":
        monkeypatch.setattr(train_mod, "mix_in_place", _skip_later_rounds(train_mod.mix_in_place))
    if mutant is not None:
        with pytest.raises(SystemExit):
            chip_smoke.phase_rounds(cfg, layout, batches)
        return
    launches, numbers = chip_smoke.phase_rounds(cfg, layout, batches)
    assert launches["gossip_program_update"] == 2 * chip_smoke.ROUND_STEPS + chip_smoke.ADA_STEPS
    for label in ("d_one_peer_exp rounds 2", "d_star rounds 3 hub-balanced"):
        cmp = numbers[label]["fused_vs_interpreter"]
        assert cmp["share_of_tolerance"] <= 1.0 and cmp["moved_share"] > 0.9
    assert len(numbers["d_star rounds 3 hub-balanced"]["stages"]) == 3
    ada = numbers["d_ada closed loop"]
    assert [s for s, _, _ in ada["trace"]] == list(range(chip_smoke.ADA_STEPS))
    assert ada["max_xi_rel_err"] <= 1e-5
    # the offset replicas make the rung move: 2 -> one_peer
    assert ada["transitions"] and ada["rung_walk"].endswith("one_peer")


def test_phase15_runs_the_paper_configurations_on_cpu(on_cpu, monkeypatch):
    monkeypatch.setattr(chip_smoke, "PAPER_CHECK_STEPS", 6)
    monkeypatch.setattr(chip_smoke, "PAPER_RUNS", {
        "resnet closed-loop Ada": dict(steps=11, lr=0.1),
        "lstm variance d_ring": dict(steps=7, lr=0.5),
    })
    launches, numbers = chip_smoke.phase_paper("cpu")
    assert launches["segment_l2_norms"] == 6 + 11 + 6 + 7
    ada = numbers["resnet closed-loop Ada"]
    assert ada["ladder"][0] == "12" and ada["ladder"][-1] == "one_peer"
    assert [s for s, _, _ in ada["trace"]] == [0, 5, 10]
    assert numbers["lstm variance d_ring"]["trace"] is None
    assert all(math.isfinite(n["final_loss"]) for n in numbers.values())


# ---------------------------------------------------------------------------
# Phases 16-18 on the CPU, at the reduced granite-8b size in bfloat16
# ---------------------------------------------------------------------------

@pytest.fixture
def no_sync_debug(monkeypatch):
    """The CPU build has no CUDA sync debug mode: the check is a no-op."""
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)


def _monolithic_ref(cfg, layout, batches, steps, sample, tail0, **kw):
    """What main() keeps from phase 4 (and, with ``fused_apply=False`` and
    dense mixing, from phase 13) for phase 16: the monolithic trainer's
    losses, norms, sampled θ and m, and the tail columns."""
    import numpy as np

    kw = {"fused_apply": True, **kw}
    trainer = SPMDTrainer(cfg, make_topology("d_ring", chip_smoke.G), sgd(momentum=0.9),
                          collect_norms=True, device="cpu", **kw)
    state = trainer.init_state(seed=0)
    losses, norms = [], []
    for t in range(steps):
        state, loss, nrm = trainer.train_step(state, batches[t], chip_smoke.LR)
        losses.append(loss.numpy().copy())
        norms.append(nrm.numpy().copy())
    idx = torch.as_tensor(sample)
    return {"losses": np.stack(losses), "norms": np.stack(norms),
            "theta": state.theta[:, idx].float().numpy(), "mom": state.mom[:, idx].numpy(),
            "tail_start": tail0, "theta_tail": state.theta[:, tail0:].clone(),
            "mom_tail": state.mom[:, tail0:].clone()}


def _width_as_row_stride(orig):
    """K1 with ``ld_state`` taken as the slice's width: right on the whole
    state, wrong rows on a bucket (a column slice)."""
    def run(theta, wire, srcs, weights, grad, mom, **kw):
        restride = lambda t: t.as_strided(t.shape, (t.shape[1], 1))
        return orig(restride(theta), wire, srcs, weights, restride(grad), restride(mom), **kw)
    return run


# bucket sizes over the reduced state's 1,443,072 columns: 551, 111 and
# 23 buckets, boundaries inside leaves, ragged tails
SMALL_MBS = (0.01, 0.05, 0.25)


@pytest.mark.parametrize("mutant", [None, "wrong-stride"])
def test_phase16_buckets_equal_monolithic_and_a_wrong_stride_fails(on_cpu, no_sync_debug,
                                                                    monkeypatch, mutant):
    cfg, layout, batches = _reduced(chip_smoke.BUCKET_STEPS + 1)
    monkeypatch.setattr(chip_smoke, "SAMPLE", 64)
    monkeypatch.setattr(chip_smoke, "BUCKET_MBS", SMALL_MBS)
    monkeypatch.setattr(chip_smoke, "INTERP_MB", 0.05)
    monkeypatch.setattr(chip_smoke, "EDGE", 64)
    sample = chip_smoke.sample_columns(layout)
    tail0 = min(chip_smoke.tail_start(layout, mb) for mb in SMALL_MBS)
    ref = _monolithic_ref(cfg, layout, batches, chip_smoke.BUCKET_STEPS, sample, tail0)
    ref_interp = _monolithic_ref(cfg, layout, batches, chip_smoke.BUCKET_STEPS, sample,
                                 chip_smoke.tail_start(layout, 0.05), fused_apply=False,
                                 mixing="dense")
    if mutant is not None:
        monkeypatch.setattr(gu, "gossip_program_update",
                            _width_as_row_stride(gu.gossip_program_update))
        with pytest.raises(SystemExit):
            chip_smoke.phase_buckets(cfg, layout, batches, ref, sample, ref_interp)
        return
    launches, numbers, err = chip_smoke.phase_buckets(cfg, layout, batches, ref, sample,
                                                      ref_interp)
    buckets = [numbers[f"{mb} MiB"]["buckets"] for mb in SMALL_MBS]
    assert buckets == [551, 111, 23] and err == 0.0
    assert numbers["0.05 MiB interpreter"]["buckets"] == 111
    assert launches["gossip_program_update"] == chip_smoke.BUCKET_STEPS * sum(buckets)
    assert launches["segment_l2_norms"] == 4 * chip_smoke.BUCKET_STEPS


@pytest.mark.parametrize("mutant", [None, "wrong-stride"])
def test_k1_slice_check_holds_the_twin_and_fails_a_wrong_stride(monkeypatch, mutant):
    """``k1_slice_against_twin`` on interior, tail and misaligned column
    slices of a (G, P) state: the true wrapper passes with error 0, one
    that takes the slice's width as its row stride fails."""
    g, p = chip_smoke.G, 1000
    gen = torch.Generator().manual_seed(0)
    theta = (torch.randn((g, p), generator=gen) * 0.02).bfloat16()
    grad = torch.randn((g, p), generator=gen).bfloat16()
    mom = torch.randn((g, p), generator=gen)
    srcs, w = chip_smoke.ring_tables("cpu")
    monkeypatch.setattr(chip_smoke, "EDGE", 16)
    monkeypatch.setattr(chip_smoke, "TWIN_CHUNK", 64)   # several chunks per slice
    theta0, mom0 = theta.clone(), mom.clone()
    if mutant is not None:
        monkeypatch.setattr(gu, "gossip_program_update",
                            _width_as_row_stride(gu.gossip_program_update))
        with pytest.raises(SystemExit):
            chip_smoke.k1_slice_against_twin("mutant", theta, mom, grad, srcs, w, 200, 456)
        return
    for a, b in ((200, 456), (768, 1000), (203, 454)):
        assert chip_smoke.k1_slice_against_twin("slice", theta, mom, grad, srcs, w, a, b) == 0.0
    # each variant restores the slice: the state is as it was
    assert torch.equal(theta, theta0) and torch.equal(mom, mom0)


def _drop_first_bucket(orig):
    """A bucket step that leaves bucket 0's Ξ² partial out of the fold."""
    def build(*args, **kw):
        fn = orig(*args, **kw)

        def step(theta_b, mom_b, grad_b, lr, tok):
            out = fn(theta_b, mom_b, grad_b, lr, tok)
            return tok if tok is not None and theta_b.storage_offset() == 0 else out
        return step
    return build


@pytest.mark.parametrize("mutant", [None, "dropped-bucket"])
def test_phase17_folded_probe_and_a_dropped_bucket_fails(on_cpu, monkeypatch, mutant):
    from repro_torch.launch import train as train_mod

    cfg, layout, batches = _reduced(chip_smoke.ADA_STEPS)
    monkeypatch.setattr(chip_smoke, "SAMPLE", 64)
    monkeypatch.setattr(chip_smoke, "FOLD_MB", 0.05)
    monkeypatch.setattr(chip_smoke, "SIM_BUCKET_MB", 0.05)
    sample = chip_smoke.sample_columns(layout)
    # phase 14's monolithic closed loop and phase 13's simulator rows
    topo = make_topology("d_ada", chip_smoke.G, k_floor="one_peer",
                         consensus_target=chip_smoke.ADA_TARGET, consensus_probe_every=1)
    trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True, fused_apply=True,
                          device="cpu")
    state = trainer.init_state(seed=0)
    before = chip_smoke.ada_before({}, layout)
    for t in range(chip_smoke.ADA_STEPS):
        before(t, state)
        state, _, _ = trainer.train_step(state, batches[t], chip_smoke.LR)
    ref14 = {"trace": [list(x) for x in topo.controller.trace],
             "transitions": topo.controller.transitions}
    rows13, _, _, _ = chip_smoke.simulator_run(cfg, batches, torch.as_tensor(sample))
    if mutant is not None:
        monkeypatch.setattr(train_mod, "build_bucket_step",
                            _drop_first_bucket(train_mod.build_bucket_step))
        with pytest.raises(SystemExit):
            chip_smoke.phase_folded_probe(cfg, layout, batches, ref14, rows13, sample)
        return
    launches, numbers = chip_smoke.phase_folded_probe(cfg, layout, batches, ref14, rows13,
                                                      sample)
    assert numbers["standalone_probes_at"] == [0] and numbers["buckets"] == 111
    assert launches["gossip_program_update"] == 111 * chip_smoke.ADA_STEPS
    assert max(numbers["max_xi_rel_err"].values()) <= 1e-5
    assert numbers["transitions"] == ref14["transitions"] != []


def test_phase18_telemetry_on_cpu(on_cpu, monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    cfg, layout, batches = _reduced(chip_smoke.TEL_STEPS)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(chip_smoke, "PAPER_CHECK_STEPS", 6)
    launches, numbers = chip_smoke.phase_telemetry(cfg, layout, batches, "cpu")
    assert launches["gossip_program_update"] == 3 * chip_smoke.TEL_STEPS
    assert numbers["trainer on"]["records"] > 0
    assert (tmp_path / "telemetry" / "resnet_cpu.jsonl").exists()


def test_compare_streams_holds_counters_exactly_and_gauges_to_the_bar():
    base = [{"kind": "counter", "step": 0, "name": "comm_bytes", "inc": 8, "total": 8},
            {"kind": "gauge", "step": 0, "name": "loss", "value": 2.0},
            {"kind": "span", "step": 0, "name": "round", "ms": 1.0}]
    chip_smoke.compare_streams("same", base, base[:2], rtol=1e-4)   # spans aside
    near = [dict(base[0]), dict(base[1], value=2.0001)]
    chip_smoke.compare_streams("near", near, base, rtol=1e-4)
    for bad in ([dict(base[0], inc=9, total=9), base[1]],
                [base[0], dict(base[1], value=2.01)], base[:1]):
        with pytest.raises(SystemExit):
            chip_smoke.compare_streams("bad", bad, base, rtol=1e-4)


# ---------------------------------------------------------------------------
# Phases 19-22 (faults) on the CPU, at the reduced granite-8b size in bfloat16
# ---------------------------------------------------------------------------

def _all_ones_rows(orig):
    """K1 that ignores the realization: all-ones fault rows."""
    def run(theta, wire, srcs, weights, grad, mom, *, fault, **kw):
        return orig(theta, wire, srcs, weights, grad, mom, fault=torch.ones_like(fault), **kw)
    return run


@pytest.mark.parametrize("mutant", [None, "all-ones-rows"])
@pytest.mark.parametrize("name", list(chip_smoke.FAULT_RUNS))
def test_phase19_20_fault_runs_and_a_kernel_ignoring_the_faults_fails(on_cpu, monkeypatch,
                                                                       name, mutant):
    cfg, layout, batches = _reduced(chip_smoke.FAULT_STEPS)
    monkeypatch.setattr(chip_smoke, "TWIN_CHUNK", 100_000)   # several chunks
    monkeypatch.setattr(chip_smoke, "FAULT_BUCKET_MB", 0.05)
    if mutant is not None:
        monkeypatch.setattr(gu, "gossip_program_update", _all_ones_rows(gu.gossip_program_update))
        with pytest.raises(SystemExit):
            chip_smoke.phase_fault_run(cfg, batches, name)
        return
    counts, numbers, final = chip_smoke.phase_fault_run(cfg, batches, name)
    assert counts["gossip_program_update"] == chip_smoke.FAULT_STEPS
    assert numbers["fused_vs_interpreter"]["share_of_tolerance"] <= 1.0
    realized = numbers["realized"]
    expect = {"crash": ("degraded_program_steps", "rejoin_steps"),
              "preempt": ("boost_steps", "depart_steps", "degraded_program_steps"),
              "spare-link": ("dropped_edge_steps", "ghost_rows"),
              "straggler": ("straggler_steps",)}[name]
    assert all(realized[k] for k in expect), realized
    counts20, numbers20 = chip_smoke.phase_fault_bucket_run(cfg, batches, name, final)
    assert numbers20["fault_rows_built"] == chip_smoke.FAULT_STEPS
    assert counts20["gossip_program_update"] == numbers20["buckets"] * chip_smoke.FAULT_STEPS


def test_phase20_fails_when_the_fault_rows_are_built_per_bucket(on_cpu, monkeypatch):
    from repro_torch.core import buckets

    cfg, layout, batches = _reduced(chip_smoke.FAULT_STEPS)
    monkeypatch.setattr(chip_smoke, "FAULT_BUCKET_MB", 0.05)
    _, _, final = chip_smoke.phase_fault_run(cfg, batches, "crash")
    orig = buckets.build_bucket_step

    def per_bucket(program, *, fault=None, kernel_split=None, **kw):
        fn = orig(program, fault=fault, kernel_split=kernel_split, **kw)
        if fault is None or kernel_split is None:
            return fn

        def step(theta_b, mom_b, grad_b, lr, tok):
            gu.fault_rows(kernel_split[0], fault, theta_b.device)
            return fn(theta_b, mom_b, grad_b, lr, tok)
        return step

    from repro_torch.launch import train as train_mod

    monkeypatch.setattr(train_mod, "build_bucket_step", per_bucket)
    with pytest.raises(SystemExit):
        chip_smoke.phase_fault_bucket_run(cfg, batches, "crash", final)


def test_phase19_fault_free_step_equals_the_fault_free_trainer(on_cpu, monkeypatch):
    import numpy as np

    cfg, layout, batches = _reduced(1)
    monkeypatch.setattr(chip_smoke, "SAMPLE", 64)
    sample = chip_smoke.sample_columns(layout)
    ref = _monolithic_ref(cfg, layout, batches, 1, sample, 0)
    step0 = {"losses": ref["losses"][0], "norms": ref["norms"][0], "theta": ref["theta"],
             "mom": ref["mom"]}
    chip_smoke.phase_fault_free_step(cfg, batches, step0, sample)
    bad = dict(step0, mom=np.asarray(step0["mom"]) * 2)
    with pytest.raises(SystemExit):
        chip_smoke.phase_fault_free_step(cfg, batches, bad, sample)


def test_phase21_simulator_equals_trainer_under_faults(on_cpu, monkeypatch):
    cfg, layout, batches = _reduced(chip_smoke.FAULT_STEPS)
    monkeypatch.setattr(chip_smoke, "FAULT_RUNS", {
        k: chip_smoke.FAULT_RUNS[k] for k in ("crash", "preempt", "spare-link")})
    counts, numbers = chip_smoke.phase_fault_simulator(cfg, batches)
    assert counts["segment_l2_norms"] == 3 * chip_smoke.FAULT_STEPS
    assert counts["gossip_program_update"] == 0


def test_phase22_ranks_equal_stacked_rows_on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SAMPLE", 64)
    cfg = chip_smoke.fault_rank_cfg("cpu")
    from repro_torch.core.flat import FlatLayout
    from repro_torch.models import transformer as tfm

    layout = FlatLayout.from_shapes({k: d.shape for k, d in tfm.model_defs(cfg).items()})
    out = chip_smoke.phase_fault_ranks(chip_smoke.sample_columns(layout), device="cpu")
    assert out["transport"] == "gloo" and out["ranks"] == chip_smoke.G


def test_compare_rows_exact_fails_a_one_ulp_difference():
    import numpy as np

    row = {"losses": np.ones(3), "norms": np.ones((3, 2)), "theta": np.ones(5),
           "mom": np.ones(5)}
    ref = {k: np.stack([v] * 2) for k, v in row.items()}
    chip_smoke.compare_rows_exact("ok", [row, row], ref)
    bad = dict(row, theta=np.nextafter(row["theta"], 2))
    with pytest.raises(SystemExit):
        chip_smoke.compare_rows_exact("bad", [row, bad], ref)


# ---------------------------------------------------------------------------
# Phases 23-26 on the CPU, at the reduced granite-8b size in bfloat16
# ---------------------------------------------------------------------------

@pytest.fixture
def ckpt_on_cpu(on_cpu, monkeypatch, tmp_path):
    """Checkpoints under the test's directory; the device memory counters
    read 0."""
    monkeypatch.setattr(chip_smoke, "CKPT_DIR", tmp_path / "ckpt")
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    return tmp_path


def _no_controller_restore(orig):
    def run(self, d):
        return orig(self, {k: v for k, v in d.items() if k != "controller"})
    return run


@pytest.mark.parametrize("mutant", [None, "controller", "momentum"])
def test_phase23_stacked_resume_and_a_lost_restore_fails(ckpt_on_cpu, monkeypatch, mutant):
    from repro_torch.launch import train as train_mod

    cfg, layout, batches = _reduced(chip_smoke.RESUME_STEPS)
    if mutant == "controller":
        monkeypatch.setattr(train_mod.SPMDTrainer, "restore_extra",
                            _no_controller_restore(train_mod.SPMDTrainer.restore_extra))
    elif mutant == "momentum":   # the momentum is left as initialised
        from repro_torch.checkpoint import ckpt as ckpt_mod

        monkeypatch.setattr(train_mod, "restore_checkpoint", lambda d, target, step=None:
                            ckpt_mod.restore_checkpoint(d, {"p": target["p"]}, step))
    if mutant is not None:
        with pytest.raises(SystemExit):
            chip_smoke.phase_stacked_resume(cfg, layout, batches, 0)
        return
    counts, numbers, members = chip_smoke.phase_stacked_resume(cfg, layout, batches, 0)
    runs = 2 * chip_smoke.RESUME_STEPS - chip_smoke.RESUME_CUT
    assert counts["gossip_program_update"] == runs and counts["segment_l2_norms"] == runs
    assert numbers["file_bytes"] >= numbers["expected_bytes"]
    assert members[0].startswith("o/") and members[-1] == "__extra__.npy"
    assert numbers["transitions"]
    assert not list((ckpt_on_cpu / "ckpt").iterdir())   # the phase removed its file


def test_phase24_ranks_resume_on_cpu(ckpt_on_cpu, monkeypatch):
    import numpy as np

    from repro_torch.checkpoint.ckpt import flatten

    monkeypatch.setattr(chip_smoke, "SAMPLE", 64)
    cfg = chip_smoke.fault_rank_cfg("cpu")
    from repro_torch.core.flat import FlatLayout
    from repro_torch.models import transformer as tfm

    layout = FlatLayout.from_shapes({k: d.shape for k, d in tfm.model_defs(cfg).items()})
    sample = chip_smoke.sample_columns(layout)
    trainer = SPMDTrainer(cfg, make_topology("d_ring", chip_smoke.G), sgd(momentum=0.9),
                          collect_norms=True, fused_apply=True, device="cpu")
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=chip_smoke.fault_rank_seq("cpu"), seed=0)
    state, _, _ = trainer.train_step(state, src.stacked(chip_smoke.G, 0, chip_smoke.BATCH),
                                     chip_smoke.LR)
    idx = torch.as_tensor(sample)
    step0 = {"theta": state.theta[:, idx].clone(), "mom": state.mom[:, idx].clone()}
    members = [k + ".npy" for k, _ in flatten(trainer.checkpoint_tree(state))] + ["__extra__.npy"]
    out = chip_smoke.phase_ranks_resume(layout, sample, step0, members, device="cpu")
    assert out["transport"] == "gloo" and out["file_bytes"] > 0
    bad = dict(step0, mom=step0["mom"] * np.float32(2))
    with pytest.raises(SystemExit):
        chip_smoke.phase_ranks_resume(layout, sample, bad, members, device="cpu")


@pytest.mark.parametrize("mutant", [None, "controller"])
def test_phase25_simulator_resume_and_a_lost_controller_fails(ckpt_on_cpu, monkeypatch,
                                                               mutant):
    from repro_torch.core import simulator as sim_mod

    monkeypatch.setattr(chip_smoke, "SIM_RESUME_STEPS", 12)
    monkeypatch.setattr(chip_smoke, "SIM_RESUME_CUT", 6)
    if mutant == "controller":
        monkeypatch.setattr(sim_mod.DecentralizedSimulator, "restore_extra",
                            _no_controller_restore(sim_mod.DecentralizedSimulator.restore_extra))
        with pytest.raises(SystemExit):
            chip_smoke.phase_sim_resume("cpu")
        return
    counts, numbers = chip_smoke.phase_sim_resume("cpu")
    assert counts["segment_l2_norms"] == 18 and numbers["probes"] == 3


def test_phase26_knobs_on_cpu(on_cpu, monkeypatch):
    import contextlib
    import io

    from repro_torch.examples import dbench_whitebox, quickstart

    def run_example(args):
        mod = {"repro_torch.examples.quickstart": quickstart,
               "repro_torch.examples.dbench_whitebox": dbench_whitebox}[args[0]]
        argv = args[1:] if mod is dbench_whitebox else ["--steps", "12"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(argv + (["--nodes", "8"] if mod is dbench_whitebox else []), device="cpu")
        return buf.getvalue(), 0.0

    monkeypatch.setattr(chip_smoke, "run_example", run_example)
    monkeypatch.setattr(chip_smoke, "EXAMPLE_STEPS", 3)
    cfg, layout, batches = _reduced(chip_smoke.KNOB_STEPS)
    counts, numbers = chip_smoke.phase_knobs(cfg, layout, batches)
    assert counts["gossip_program_update"] == 3 * chip_smoke.KNOB_STEPS
    assert numbers["accum"]["share_of_bar"] <= 1.0
    assert numbers["quickstart"]["loss_to"] < numbers["quickstart"]["loss_from"]


def test_accum_bar_fails_a_step_off_by_more_than_its_bar():
    cfg, layout, batches = _reduced(1)
    trainer = SPMDTrainer(cfg, make_topology("d_ring", chip_smoke.G), sgd(momentum=0.9),
                          fused_apply=True, device="cpu")
    state = trainer.init_state(seed=0)
    state, loss, _ = trainer.train_step(state, batches[0], chip_smoke.LR)
    other = state.clone()
    chip_smoke.accum_bar(layout, (state, loss), (other, loss.clone()))
    other.theta[0, 5] += 0.05
    with pytest.raises(SystemExit):
        chip_smoke.accum_bar(layout, (state, loss), (other, loss.clone()))
    other = state.clone()
    other.mom[1, -3] += 1.0
    with pytest.raises(SystemExit):
        chip_smoke.accum_bar(layout, (state, loss), (other, loss.clone()))
    with pytest.raises(SystemExit):
        chip_smoke.accum_bar(layout, (state, loss), (state.clone(), loss * 1.1))
