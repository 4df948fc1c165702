"""Port parity: elastic membership and the trainer under faults, mirroring
``tests/test_elastic.py`` (concurrent crashes, preemption drains, joins)
and ``tests/faults_spmd_script.py`` (the trainer against the simulator).

* Mask composition: degrading by mask A and then masking by B realizes
  ``degraded_matrix(W, A & B)``, within 1e-6 of the reference's realized
  matrix; a drain boost keeps W doubly stochastic; ``drain_handoff``
  keeps the survivors' mean at the global mean; joins grow the simulator
  and re-derive the topology, with the reference's programs at every
  size.
* The stacked trainer (granite-8b-reduced, float32, G = 4, sgd(0.9), the
  reference's weights) under crash with rejoin, preempt, dropout, link,
  straggler and a spare pool, through the interpreter and through K1's
  twin, monolithic and bucketed: within 5e-5 of the reference's dense
  simulator under the same model (losses within 5e-5 of their size, norms
  rtol 1e-5); bucketed bit for bit monolithic, the kernel's fault rows
  built once a step; a step that realizes no fault bit for bit the
  fault-free trainer's.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dsgd as jdsgd  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.simulator import DecentralizedSimulator as JSim  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import dsgd as tdsgd  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.ada import AdaSchedule  # noqa: E402
from repro_torch.core.consensus import ConsensusController  # noqa: E402
from repro_torch.kernels import gossip_update as gu  # noqa: E402
from repro_torch.launch.train import SPMDTrainer, main  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from test_torch_faults import (  # noqa: E402
    D, TSim, _tloss, both_graphs, quad_batch, random_connected_edges, toptim,
)
from test_torch_train import BATCH, G, LR, SEQ, _flat_np, _init  # noqa: E402

torch.set_num_threads(1)
joptim = importlib.import_module("repro.optim.sgd")


def realized_matrix(program, alive_a, alive_b):
    """The matrix degrade(A) + runtime mask(B) applies, from the port."""
    eye = torch.eye(program.n)
    out = program.degrade(tuple(bool(a) for a in alive_a)).apply_masked(eye, alive_b)
    return out.numpy().astype(np.float64)


def ref_realized_matrix(program, alive_a, alive_b):
    eye = {"w": jnp.eye(program.n, dtype=jnp.float32)}
    out = program.degrade(tuple(bool(a) for a in alive_a)).apply_masked(
        eye, jnp.asarray(alive_b, jnp.float32))
    return np.asarray(out["w"], dtype=np.float64)


# ---------------------------------------------------------------------------
# Mask composition and concurrent crashes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_composed_masks_equal_dense_oracle_two_crashes(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(5, 12))
    tg, jg = both_graphs(random_connected_edges(n, seed))
    tprog, jprog = tsched.compile_graph(tg), tsched.compile_graph(tg)
    jprog = importlib.import_module("repro.core.schedule").compile_graph(jg)
    a, b = rng.choice(n, size=2, replace=False)
    mask_a, mask_b = np.ones(n, bool), np.ones(n, bool)
    mask_a[a] = False
    mask_b[b] = False
    realized = realized_matrix(tprog, mask_a, mask_b)
    assert np.abs(realized - ref_realized_matrix(jprog, mask_a, mask_b)).max() <= 1e-6
    oracle = tfaults.degraded_matrix(tg.mixing_matrix(), mask_a & mask_b)
    assert np.abs(realized - oracle).max() <= 1e-6
    surv = mask_a & mask_b
    block = realized[np.ix_(surv, surv)]
    assert np.abs(block - block.T).max() <= 1e-6
    np.testing.assert_allclose(block.sum(axis=0), 1.0, atol=1e-6)
    for d in np.nonzero(~surv)[0]:
        np.testing.assert_allclose(realized[d], np.eye(n)[d], atol=1e-6)


def test_composed_masks_match_direct_multinode_degrade():
    tg, _ = both_graphs(random_connected_edges(9, 3))
    prog = tsched.compile_graph(tg)
    mask_a, mask_b = np.ones(9, bool), np.ones(9, bool)
    mask_a[2] = False
    mask_b[6] = False
    ab, ba = realized_matrix(prog, mask_a, mask_b), realized_matrix(prog, mask_b, mask_a)
    direct = realized_matrix(prog, mask_a & mask_b, np.ones(9))
    assert np.abs(ab - ba).max() <= 1e-6 and np.abs(ab - direct).max() <= 1e-6


def test_concurrent_crash_timeline_and_modes():
    m = tfaults.ConcurrentCrash(n=10, rate=0.6, seed=4, k=3, down_steps=4)
    ref = jfaults.ConcurrentCrash(n=10, rate=0.6, seed=4, k=3, down_steps=4)
    assert m.victims == ref.victims and m.onsets == ref.onsets and len(set(m.victims)) == 3
    fr = m.at(max(m.onsets))
    assert not fr.program_alive.all() and fr.selection_mask().all()
    assert {v for t in range(30) for v in m.at(t).rejoin} == set(m.victims)


def test_concurrent_enumerated_masks_are_bounded_and_realized():
    m = tfaults.ConcurrentCrash(n=10, rate=0.6, seed=4, k=3, down_steps=4,
                                enumerate_programs=True)
    masks = m.program_masks()
    assert 1 <= len(masks) <= 6
    assert masks == jfaults.ConcurrentCrash(n=10, rate=0.6, seed=4, k=3, down_steps=4,
                                            enumerate_programs=True).program_masks()
    realized = {tuple(bool(a) for a in m.at(t).program_alive) for t in range(40)}
    assert realized - {(True,) * 10} == set(masks)
    assert not m.at(max(m.onsets)).selection_mask().all()


# ---------------------------------------------------------------------------
# Preemption: the boosted drain and the handoff
# ---------------------------------------------------------------------------

def test_drain_boost_keeps_matrix_doubly_stochastic():
    tg, _ = both_graphs(random_connected_edges(8, 7))
    boost = np.ones(8)
    boost[3] = 1.5
    realized = realized_matrix(tsched.compile_graph(tg), np.ones(8), boost)
    assert np.abs(realized - tfaults.degraded_matrix(tg.mixing_matrix(), boost)).max() <= 1e-6
    np.testing.assert_allclose(realized.sum(axis=0), 1.0, atol=1e-6)
    np.testing.assert_allclose(realized.sum(axis=1), 1.0, atol=1e-6)
    assert np.abs(realized - realized.T).max() <= 1e-6


def test_preemption_departs_once_after_drain():
    m = tfaults.Preemption(n=8, rate=0.5, seed=2, drain_steps=3)
    a, d = m.announce_step, m.depart_step
    assert d == a + 3
    for t in range(a, d):
        fr = m.at(t)
        assert fr.alive[m.victim] == pytest.approx(1.5) and fr.faulty
    assert [t for t in range(d + 10) if m.at(t).depart] == [d]
    assert len(m.program_masks()) == 1


def test_drain_handoff_and_adopt_equal_reference():
    """The in-place row handoffs of the flat state against the reference's
    tree maps: float32 within 1e-6, bfloat16 within one ulp; the drain
    keeps the survivors' mean at the global mean."""
    rng = np.random.default_rng(11)
    n, node = 9, 4
    x = rng.normal(size=(n, 5)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[node] = False
    want = np.asarray(jfaults.drain_handoff({"w": jnp.asarray(x)}, node, [3, 5, 8], alive)["w"])
    got = torch.from_numpy(x.copy())
    tfaults.drain_handoff(got, node, [3, 5, 8], alive)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[alive].astype(np.float64).mean(0),
                               x.astype(np.float64).mean(0), atol=1e-6)
    untouched = [i for i in range(n) if i not in (3, 5, 8)]
    np.testing.assert_array_equal(got.numpy()[untouched], x[untouched])
    xb = torch.from_numpy(x).bfloat16()
    tfaults.adopt_neighbor_average(xb, 2, [1, 3, 6])
    want_b = jfaults.adopt_neighbor_average({"w": jnp.asarray(x, jnp.bfloat16)}, 2, [1, 3, 6])
    np.testing.assert_allclose(xb.float().numpy(), np.asarray(want_b["w"], np.float32),
                               rtol=2 ** -7)
    # a per-node step counter (AdamW's "t") adopts like any other buffer
    t = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
    tfaults.adopt_neighbor_average(t, 0, [1, 2])
    assert t.tolist() == [6, 5, 7, 9]


def test_preemption_preserves_survivor_mean_hard_crash_does_not():
    def mean_jump(kind):
        fm = tfaults.make_fault_model(kind, 8, rate=0.5, seed=2, drain_steps=3) \
            if kind == "preempt" else tfaults.make_fault_model(kind, 8, rate=0.5, seed=2)
        sim = TSim(_tloss, toptim.sgd(0.1), tdsgd.make_topology("d_ring", 8, fault_model=fm),
                   device="cpu")
        state = sim.init({"w": np.zeros(D, np.float32)})
        state.theta.copy_(torch.from_numpy(
            np.random.default_rng(5).normal(size=(8, D)).astype(np.float32)))
        event = fm.depart_step if kind == "preempt" else fm.crash_step
        zero = {"obs": np.zeros((8, 2, D), np.float32)}
        for _ in range(event):
            state, _, _ = sim.train_step(state, zero, 0.0)
        pre = state.theta.numpy().astype(np.float64).mean(0)
        state, _, _ = sim.train_step(state, zero, 0.0)
        surv = np.asarray(fm.at(event).alive) != 0
        return float(np.abs(state.theta.numpy().astype(np.float64)[surv].mean(0) - pre).max())

    assert mean_jump("preempt") <= 1e-6
    assert mean_jump("crash") > 1e-3


# ---------------------------------------------------------------------------
# Re-arming and joins
# ---------------------------------------------------------------------------

def _controller(n=8):
    return ConsensusController(
        schedule=AdaSchedule(n_nodes=n, k0=3, gamma_k=0.02, k_floor="one_peer"), target=0.5)


def test_simultaneous_concurrent_crash_logs_single_rearm():
    fm = tfaults.ConcurrentCrash(n=8, rate=0.999, seed=0, k=3)
    assert len(set(fm.onsets)) == 1
    topo = tdsgd.make_topology("d_ada", 8, consensus_target=0.25, k_floor="one_peer",
                               fault_model=fm)
    sim = TSim(_tloss, toptim.sgd(0.1), topo, device="cpu")
    state = sim.init({"w": np.zeros(D, np.float32)})
    rng = np.random.default_rng(0)
    for _ in range(4):
        state, _, _ = sim.train_step(state, quad_batch(rng, 8), 0.05)
    events = topo.controller.events
    assert len(events) == 1 and events[0] == (fm.onsets[0], "membership")


def test_join_grows_membership_and_topology():
    fm = tfaults.Join(n=4, rate=0.0, seed=0, join_steps=(3, 5))
    assert fm.elastic and fm.membership_sizes() == (4, 5, 6)
    topo = tdsgd.make_topology("d_ring", 4, fault_model=fm)
    sim = TSim(_tloss, toptim.sgd(0.1), topo, device="cpu")
    state = sim.init({"w": np.zeros(D, np.float32)})
    rng = np.random.default_rng(0)
    for t in range(8):
        m = fm.n_at(t)
        state, loss, _ = sim.train_step(state, quad_batch(rng, m), 0.05)
        assert state.theta.shape[0] == m and loss.shape[0] == m
        assert state.opt["mom"].shape[0] == m
    assert sim.n == 6 and sim.topology.n_nodes == 6 and sim.topology.fault_model is fm
    assert torch.isfinite(state.theta).all()


def test_join_programs_and_resized_topologies_match_reference():
    for name, kw in [("d_ring", {}), ("d_one_peer_exp", {}),
                     ("d_ada", dict(k0=3, k_floor="one_peer", consensus_target=0.5))]:
        fm_t = tfaults.Join(n=4, rate=0.0, seed=0, join_steps=(2, 4))
        fm_j = jfaults.Join(n=4, rate=0.0, seed=0, join_steps=(2, 4))
        t_topo = tdsgd.make_topology(name, 4, fault_model=fm_t, **kw)
        j_topo = jdsgd.make_topology(name, 4, fault_model=fm_j, **kw)
        assert [(k, p.cache_key) for k, p in t_topo.distinct_programs()] == [
            (k, p.cache_key) for k, p in j_topo.distinct_programs()]
        grown_t, grown_j = t_topo.resized(6), j_topo.resized(6)
        assert grown_t.n_nodes == 6 and grown_t.fault_model is fm_t
        assert grown_t.describe() == grown_j.describe()
    with pytest.raises(ValueError, match="d_custom"):
        tdsgd.make_topology("d_custom", 3, adjacency=[(0, 1), (1, 2)]).resized(4)


def test_joining_node_adopts_neighbor_average():
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    grown = tfaults.admit_node(x, [0, 2])
    assert grown.shape == (5, 2) and torch.equal(grown[:4], x)
    np.testing.assert_allclose(grown[4].numpy(), x.numpy()[[0, 2]].mean(0))
    np.testing.assert_allclose(tfaults.admit_node(x, [])[4].numpy(), x.numpy().mean(0))
    want = jfaults.admit_node({"w": jnp.asarray(x.numpy())}, [1, 3])["w"]
    np.testing.assert_allclose(tfaults.admit_node(x, [1, 3]).numpy(), np.asarray(want),
                               atol=1e-6)


def test_controller_adopt_clamps_rung_to_new_ladder():
    old = _controller(n=16)
    old.rung = len(old.ladder) - 1
    old.transitions.append((7, old.rung))
    old.events.append((3, "membership"))
    new = _controller(n=17)
    new.adopt(old)
    assert new.rung == min(old.rung, len(new.ladder) - 1)
    assert new.transitions == old.transitions and new.events == old.events


def test_trainer_rejects_elastic_models_with_the_reference_message():
    fm = tfaults.Join(n=4, rate=0.0, seed=0, join_steps=(2,))
    topo = tdsgd.make_topology("d_ring", 4, fault_model=fm)
    with pytest.raises(ValueError, match="elastic") as err:
        SPMDTrainer(tget_config("granite-8b-reduced"), topo, toptim.sgd(0.9), device="cpu")
    assert "--spare-ranks" in str(err.value) and "DecentralizedSimulator" in str(err.value)
    with pytest.raises(ValueError, match="elastic"):
        main(["--reduced", "--steps", "1", "--fault-model", "join",
              "--fault-join-steps", "2"], device="cpu")


def test_topology_adaptive_matches_reference():
    """``Topology.adaptive`` as ``tests/test_ada.py`` asserts it."""
    for name in ("d_ada", "d_ring", "d_one_peer_exp", "c_complete"):
        assert tdsgd.make_topology(name, 8).adaptive == jdsgd.make_topology(name, 8).adaptive
    assert tdsgd.make_topology("d_ada", 8).adaptive
    assert not tdsgd.make_topology("d_ring", 8).adaptive


# ---------------------------------------------------------------------------
# The stacked trainer under faults
# ---------------------------------------------------------------------------

STEPS = 5
# name -> (fault kind, make_fault_model kwargs) at G = 4 nodes
TRAINER_FAULTS = {
    "crash": ("crash", dict(rate=0.5, seed=2, down_steps=2)),
    "preempt": ("preempt", dict(rate=0.5, seed=2, drain_steps=2)),
    "dropout": ("dropout", dict(rate=0.3, seed=2)),
    "link": ("link", dict(rate=0.4, seed=1)),
    "straggler": ("straggler", dict(rate=0.3, seed=2)),
    "spare": ("join", dict(rate=0.0, seed=1, join_steps=(2,), spare_ranks=1)),
}


@functools.lru_cache(maxsize=None)
def _oracle(name):
    """The reference's dense simulator under the fault model: (params,
    [losses], [norms])."""
    kind, kw = TRAINER_FAULTS[name]
    cfg, params = _init()
    topo = jdsgd.make_topology("d_ring", G, fault_model=jfaults.make_fault_model(kind, G, **kw))
    sim = JSim(lambda p, b: jtfm.loss_fn(p, cfg, b), joptim.sgd(momentum=0.9), topo,
               mixing="dense", collect_norms=True)
    state = sim.init(jax.tree.map(jnp.asarray, params))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    for t in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in src.stacked(G, t, BATCH).items()}
        state, loss, nrm = sim.train_step(state, batch, LR)
        losses.append(np.asarray(loss))
        norms.append(np.asarray(nrm))
    return _flat_np(jax.device_get(state.params)), losses, norms


def run_trainer(name, *, fused, bucket_mb=None, steps=STEPS, fault=True):
    """The port's stacked trainer: (final θ (G, P) copy, {leaf: (G, ...)},
    [losses], [norms], trainer)."""
    kind, kw = TRAINER_FAULTS[name]
    _, params = _init()
    cfg = tget_config("granite-8b-reduced")
    fm = tfaults.make_fault_model(kind, G, **kw) if fault else None
    trainer = SPMDTrainer(cfg, tdsgd.make_topology("d_ring", G, fault_model=fm),
                          toptim.sgd(momentum=0.9), collect_norms=True, fused_apply=fused,
                          bucket_mb=bucket_mb, device="cpu")
    state = trainer.init_state(params=params_from_jax(params))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    for t in range(steps):
        state, loss, nrm = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
        losses.append(loss.numpy().copy())
        norms.append(nrm.numpy().copy())
    leaves = {k: v.numpy().copy() for k, v in trainer.stacked_params(state).items()}
    return state.theta.clone(), state.mom.clone(), leaves, losses, norms


@pytest.mark.parametrize("fused", [False, True], ids=["interpreter", "fused"])
@pytest.mark.parametrize("name", list(TRAINER_FAULTS))
def test_trainer_matches_reference_simulator_under_faults(name, fused):
    want_p, want_l, want_n = _oracle(name)
    theta, mom, got_p, got_l, got_n = run_trainer(name, fused=fused)
    assert list(got_p) == list(want_p)
    assert max(float(np.abs(got_p[k] - want_p[k]).max()) for k in want_p) < 5e-5
    for a, b in zip(got_l, want_l):
        assert (np.abs(a - b) <= 5e-5 * np.maximum(1.0, np.abs(b))).all()
    for a, b in zip(got_n, want_n):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    # the bucketed faulty step is the monolithic one, bit for bit
    b_theta, b_mom, *_ = run_trainer(name, fused=fused, bucket_mb=0.01)
    assert torch.equal(b_theta, theta) and torch.equal(b_mom, mom)


def test_trainer_faulty_step_equals_port_simulator():
    """The trainer without fused apply and the port's simulator (stacked
    mixing, autograd one node at a time) under the same model: bit for
    bit, as the fault-free engines."""
    from repro_torch.models import transformer as ttfm

    for name in ("crash", "preempt", "spare"):
        kind, kw = TRAINER_FAULTS[name]
        _, params = _init()
        cfg = tget_config("granite-8b-reduced")
        fm = tfaults.make_fault_model(kind, G, **kw)
        sim = TSim(lambda p, b: ttfm.loss_fn(p, cfg, b), toptim.sgd(momentum=0.9),
                   tdsgd.make_topology("d_ring", G, fault_model=fm), mixing="shift",
                   node_loop=True, collect_norms=True, device="cpu")
        state = sim.init(params_from_jax(params))
        src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
        for t in range(STEPS):
            state, _, _ = sim.train_step(state, src.stacked(G, t, BATCH), LR)
        theta, *_ = run_trainer(name, fused=False)
        assert torch.equal(state.theta, theta), name


def test_bucketed_fused_step_builds_fault_rows_once_per_step(monkeypatch):
    calls = []
    real = gu.fault_rows

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(gu, "fault_rows", counting)
    cfg = tget_config("granite-8b-reduced")
    fm = tfaults.make_fault_model("dropout", G, rate=0.3, seed=2)
    trainer = SPMDTrainer(cfg, tdsgd.make_topology("d_ring", G, fault_model=fm),
                          toptim.sgd(0.9), fused_apply=True, bucket_mb=0.01, device="cpu")
    assert trainer._bucket_layout.num_buckets > 10
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=8, seed=0)
    for t in range(3):
        state, _, _ = trainer.train_step(state, src.stacked(G, t, 1), LR)
    assert len(calls) == 3


def test_step_that_realizes_no_fault_is_the_fault_free_step():
    """Before the crash step every realization is all-ones: the fused
    trainer's state equals the fault-free trainer's bit for bit."""
    fm = tfaults.make_fault_model(*TRAINER_FAULTS["crash"][:1], G,
                                  **TRAINER_FAULTS["crash"][1])
    clean_steps = fm.crash_step
    assert clean_steps >= 1 and not fm.at(0).faulty
    for fused in (False, True):
        a = run_trainer("crash", fused=fused, steps=clean_steps)
        b = run_trainer("crash", fused=fused, steps=clean_steps, fault=False)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_masked_bucketed_variants_equal_per_bucket_masked_mix():
    from repro_torch.core.buckets import BucketLayout
    from repro_torch.core.graphs import Ring

    prog = tsched.compile_graph(Ring(4))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 11)).astype(np.float32))
    alive = np.array([1.0, 1.5, 0.0, 1.0])
    out = prog.apply_masked_bucketed(x, alive, layout=BucketLayout((6, 5), 4))
    assert torch.equal(out, prog.apply_masked(x, alive))


def test_main_runs_fault_models(capsys):
    out = main(["--reduced", "--steps", "4", "--topology", "d_ring", "--fused-apply",
                "--seq", "16", "--fault-model", "crash", "--fault-rate", "0.5",
                "--fault-seed", "2", "--fault-down-steps", "2"], device="cpu")
    assert all(np.isfinite(out["losses"]))
    assert "[faults: crash(n=4" in capsys.readouterr().out
    out = main(["--reduced", "--steps", "3", "--topology", "d_ring", "--seq", "16",
                "--fault-model", "join", "--fault-join-steps", "1", "--spare-ranks", "1",
                "--bucket-mb", "0.01"], device="cpu")
    trainer = out["trainer"]
    assert isinstance(trainer.fault_model, tfaults.SparePool)
    assert trainer._last_membership == (True,) * 4
    assert dataclasses.is_dataclass(out["state"])
