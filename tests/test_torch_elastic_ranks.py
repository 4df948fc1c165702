"""Port parity: spare pools, gossip deadlines and the ranks engine under
faults, mirroring ``tests/test_elastic_spmd.py``.

* ``SparePool`` and ``GossipDeadline`` realize the reference's masks, ghost
  rows degrade to the identity, a spare activates as a rejoin, deadline
  misses keep the local step under exponential backoff, and the engines
  keep the measured round trace against the deadline.
* A world of 4 gloo ranks on the CPU (one per module, with its own hard
  timeout, so that a rank that skips a collective fails the test instead
  of hanging it) runs the ranks engine under faults: a crash with rejoin
  and a preemption drain (fused K2 and interpreter), a spare pool over
  dropout and the closed loop under a crash.  Each rank's final θ and m
  equal its row of the stacked trainer bit for bit, and ranks and stacked
  share the controller's events.  The masked shard interpreter (and its
  bucketed variant) equals the reference's ``apply_masked`` within 1e-6,
  and the handoffs and the member Ξ over ranks equal the stacked ones.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_rank_worker  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import graphs as jgraphs  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.consensus import consensus_distance_masked  # noqa: E402
from repro_torch.core.dsgd import make_topology  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402
from test_torch_faults import (  # noqa: E402
    D, TSim, _tloss, assert_same_realization, quad_batch, toptim,
)
from test_torch_train import BATCH, G, LR, SEQ, _init  # noqa: E402

torch.set_num_threads(1)
WORLD_TIMEOUT = 150
FAULT_STEPS = 5

# name -> (topology, fused, fault kind, fault kwargs[, make_topology kwargs]):
# crash seed 2 kills node 2 at step 1 and rejoins it at step 3; preempt
# seed 2 drains node 2 at steps 1-2 (boost 1.5) and it departs at step 3
RANK_CASES = {
    "crash-rejoin-fused": ("d_ring", True, "crash", dict(rate=0.5, seed=2, down_steps=2)),
    "crash-rejoin-interpreter": ("d_ring", False, "crash",
                                 dict(rate=0.5, seed=2, down_steps=2)),
    "preempt-fused": ("d_ring", True, "preempt", dict(rate=0.5, seed=2, drain_steps=2)),
    "preempt-interpreter": ("d_ring", False, "preempt", dict(rate=0.5, seed=2, drain_steps=2)),
    "spare-dropout-fused": ("d_ring", True, "dropout", dict(rate=0.3, seed=2, spare_ranks=1)),
    "closed-loop-crash-fused": ("d_ada", True, "crash", dict(rate=0.5, seed=2, down_steps=2),
                                dict(k_floor="one_peer", consensus_target=0.9)),
}


def _stacked_case(case, tparams):
    """The stacked trainer's (θ, m, losses, controller events) of a case."""
    topology, fused, kind, fkw, *topo_kw = RANK_CASES[case]
    cfg = get_config("granite-8b-reduced")
    fm = tfaults.make_fault_model(kind, G, **fkw)
    topo = make_topology(topology, G, fault_model=fm, **(topo_kw[0] if topo_kw else {}))
    trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True,
                          fused_apply=fused, device="cpu")
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in tparams.items()})
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses = []
    for t in range(FAULT_STEPS):
        state, loss, _ = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
        losses.append(loss.numpy().copy())
    events = None if topo.controller is None else list(topo.controller.events)
    return state.theta.numpy(), state.mom.numpy(), np.stack(losses, 1), events


def _mask_cases():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(G, 37)).astype(np.float32)
    up = np.triu(rng.random((G, G)) > 0.4, 1)
    link = (up | up.T | np.eye(G, dtype=bool)).astype(np.float32)
    boost = np.array([1.0, 1.5, 1.0, 0.0], np.float32)
    return {
        "ring-boost-dead": (("Ring", G), x, boost, None, ((20, 17), 8)),
        "star-link": (("Star", G), x, np.ones(G, np.float32), link, None),
        "complete-dead": (("Complete", G), x, np.array([1, 1, 0, 1], np.float32), None, None),
    }


HANDOFF_X = np.random.default_rng(9).normal(size=(G, 29)).astype(np.float32)
HANDOFF_ALIVE = np.array([1.0, 1.0, 1.0, 1.5], np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, params = _init()
    tparams = {k: v.numpy() for k, v in params_from_jax(params).items()}
    results = spawn_world(
        _torch_rank_worker.fault_world, G,
        (RANK_CASES, _mask_cases(), HANDOFF_X, HANDOFF_ALIVE, tparams, FAULT_STEPS, SEQ,
         BATCH, LR),
        timeout=WORLD_TIMEOUT, device="cpu", workdir=tmp_path_factory.mktemp("world"),
    )
    return results, tparams


# ---------------------------------------------------------------------------
# SparePool
# ---------------------------------------------------------------------------

def test_spare_pool_pads_ghosts_and_activates_on_join():
    fm = tfaults.make_fault_model("join", 6, seed=5, join_steps=(4,), spare_ranks=2)
    ref = jfaults.make_fault_model("join", 6, seed=5, join_steps=(4,), spare_ranks=2)
    assert isinstance(fm, tfaults.SparePool) and not fm.elastic
    assert (fm.n, fm.spares, fm.n_active0) == (6, 2, 4)
    fr0 = fm.at(0)
    np.testing.assert_array_equal(fr0.alive, [1, 1, 1, 1, 0, 0])
    assert fr0.selection_mask().all() and fm.program_masks() == () and fr0.faulty
    assert fm.at(4).rejoin == (4,) and fm.activation_steps() == (4,)
    assert fm.at(3).membership_key() != fm.at(4).membership_key()
    for t in range(8):
        assert_same_realization(fm.at(t), ref.at(t), f"t={t}")


def test_spare_pool_ghost_rows_renormalize_to_identity():
    """Ghost rows of the degraded ring are identity rows and columns, in
    the dense oracle and in the masked interpreter and K1's twin."""
    from repro_torch.core.graphs import Ring
    from repro_torch.core.schedule import compile_graph
    from repro_torch.kernels.gossip_update import fused_apply_stacked

    alive = np.array([True, True, True, True, False, False])
    dm = tfaults.degraded_matrix(Ring(6).mixing_matrix(), alive)
    np.testing.assert_array_equal(dm, jfaults.degraded_matrix(
        jgraphs.Ring(6).mixing_matrix(), alive))
    for g in (4, 5):
        np.testing.assert_allclose(dm[g], np.eye(6)[g], atol=1e-12)
        np.testing.assert_allclose(dm[:, g], np.eye(6)[g], atol=1e-12)
    prog = compile_graph(Ring(6))
    x = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)
    out = prog.apply_masked(torch.from_numpy(x), alive).numpy()
    np.testing.assert_array_equal(out[4:], x[4:])
    theta, mom = torch.from_numpy(x.copy()), torch.zeros(6, 5)
    fault = {"update": alive.astype(np.float32), "alive": alive.astype(np.float32), "link": None}
    fused_apply_stacked(prog, theta, torch.ones(6, 5), mom, lr=0.1, beta=0.9, fault=fault)
    np.testing.assert_array_equal(theta.numpy()[4:], x[4:])


def test_spare_pool_pure_overprovision_and_inner_composition():
    fm = tfaults.make_fault_model("none", 4, spare_ranks=2)
    assert isinstance(fm, tfaults.SparePool) and fm.inner is None
    np.testing.assert_array_equal(fm.at(7).alive, [1, 1, 0, 0])
    fm2 = tfaults.make_fault_model("deadline", 6, rate=0.6, seed=4, spare_ranks=2)
    assert isinstance(fm2.inner, tfaults.GossipDeadline) and fm2.inner.n == 4
    assert fm2.deadline_ms == fm2.inner.deadline_ms
    ref = jfaults.make_fault_model("deadline", 6, rate=0.6, seed=4, spare_ranks=2)
    for t in range(10):
        np.testing.assert_array_equal(fm2.at(t).alive[4:], [0, 0])
        assert_same_realization(fm2.at(t), ref.at(t), f"t={t}")


def test_spare_pool_validation():
    with pytest.raises(ValueError, match="spares"):
        tfaults.SparePool(n=4, rate=0.0, seed=0, spares=4, inner=None)
    with pytest.raises(ValueError, match="inner"):
        tfaults.SparePool(n=4, rate=0.0, seed=0, spares=1,
                          inner=tfaults.Join(n=4, rate=0.0, seed=0, join_steps=(2,)))
    with pytest.raises(ValueError, match="join"):
        tfaults.SparePool(n=4, rate=0.0, seed=0, spares=1,
                          inner=tfaults.Join(n=3, rate=0.0, seed=0, join_steps=(2, 4)))


def test_spare_activation_join_on_simulator_keeps_ghosts_frozen():
    fm = tfaults.make_fault_model("join", 6, seed=5, join_steps=(3,), spare_ranks=2)
    sim = TSim(_tloss, toptim.sgd(0.1), make_topology("d_ring", 6, fault_model=fm),
               device="cpu")
    state = sim.init({"w": np.zeros(D, np.float32)})
    rng = np.random.default_rng(0)
    state.theta.copy_(torch.from_numpy(rng.normal(size=(6, D)).astype(np.float32)))
    init_rows = state.theta.numpy().copy()
    for _ in range(3):
        state, _, _ = sim.train_step(state, quad_batch(rng, 6), 0.05)
        np.testing.assert_array_equal(state.theta.numpy()[4:], init_rows[4:])
    state, _, _ = sim.train_step(state, quad_batch(rng, 6), 0.05)
    post = state.theta.numpy()
    assert not np.array_equal(post[4], init_rows[4])
    np.testing.assert_array_equal(post[5], init_rows[5])


# ---------------------------------------------------------------------------
# GossipDeadline
# ---------------------------------------------------------------------------

def test_deadline_miss_masks_gossip_but_keeps_local_update():
    fm = tfaults.GossipDeadline(n=8, rate=0.5, seed=4)
    ref = jfaults.GossipDeadline(n=8, rate=0.5, seed=4)
    missed = False
    for t in range(20):
        fr = fm.at(t)
        np.testing.assert_array_equal(fr.update, np.ones(8))
        assert fr.program_alive.all() and fr.selection_mask().all()
        missed |= not fr.alive.all()
        np.testing.assert_array_equal(fm.latency_ms(t), ref.latency_ms(t))
    assert missed


def test_deadline_backoff_benches_exponentially():
    fm = tfaults.GossipDeadline(n=4, rate=0.5, seed=0, backoff=2.0)
    penalty, suspend = np.ones(4), np.zeros(4, dtype=np.int64)
    best = np.zeros(4, int)
    run = np.zeros(4, int)
    for t in range(64):
        miss = fm.latency_ms(t) > fm.deadline_ms
        benched = suspend > 0
        expect = ~(miss | benched)
        np.testing.assert_array_equal(fm.at(t).alive, expect, err_msg=f"step {t}")
        suspend[benched] -= 1
        fresh = miss & ~benched
        suspend[fresh] += np.round(penalty[fresh]).astype(np.int64)
        penalty[fresh] = np.minimum(penalty[fresh] * 2.0, 64.0)
        penalty[expect] = 1.0
        run = np.where(expect, 0, run + 1)
        best = np.maximum(best, run)
    assert best.max() >= 3


def test_deadline_determinism_out_of_order():
    a = tfaults.GossipDeadline(n=6, rate=0.5, seed=9)
    b = jfaults.GossipDeadline(n=6, rate=0.5, seed=9)
    for t in [0, 1, 5, 17, 17, 3, 11, 2]:
        np.testing.assert_array_equal(a.at(t).alive, b.at(t).alive)


def test_deadline_validation_and_factory():
    with pytest.raises(ValueError, match="deadline_ms"):
        tfaults.GossipDeadline(n=4, rate=0.5, seed=0, deadline_ms=0.0)
    with pytest.raises(ValueError, match="backoff"):
        tfaults.GossipDeadline(n=4, rate=0.5, seed=0, backoff=0.5)
    assert tfaults.make_fault_model("deadline", 8, rate=0.0) is None
    fm = tfaults.make_fault_model("deadline", 8, rate=0.3, seed=1, deadline_ms=12.0,
                                  deadline_backoff=3.0)
    assert fm.deadline_ms == 12.0 and fm.backoff == 3.0
    with pytest.raises(ValueError, match="down_steps"):
        tfaults.make_fault_model("deadline", 8, rate=0.3, down_steps=4)


@pytest.mark.parametrize("engine", ["simulator", "trainer"])
def test_deadline_round_trace_is_recorded(engine):
    """Both engines time every round against the model's deadline (the
    recorder's ``configure``), with no sink attached."""
    fm = tfaults.make_fault_model("deadline", 4, rate=0.5, seed=4, deadline_ms=1e-3)
    topo = make_topology("d_ring", 4, fault_model=fm)
    rng = np.random.default_rng(0)
    if engine == "simulator":
        eng = TSim(_tloss, toptim.sgd(0.1), topo, device="cpu")
        state = eng.init({"w": np.zeros(D, np.float32)})
        for _ in range(5):
            state, _, _ = eng.train_step(state, quad_batch(rng, 4), 0.05)
    else:
        cfg = get_config("granite-8b-reduced")
        eng = SPMDTrainer(cfg, topo, sgd(0.9), device="cpu")
        state = eng.init_state(seed=0)
        src = SyntheticLM(vocab=cfg.vocab, seq_len=8, seed=0)
        for t in range(5):
            state, _, _ = eng.train_step(state, src.stacked(4, t, 1), 0.05)
    assert eng.telemetry.deadline_ms == 1e-3 and eng.telemetry.timing
    assert len(eng.round_ms) == 5 and all(ms > 0 for ms in eng.round_ms)
    assert eng.deadline_overruns == 5   # nothing runs a step in a microsecond


# ---------------------------------------------------------------------------
# The ranks engine under faults (one gloo world)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(RANK_CASES))
def test_ranks_equal_stacked_rows_under_faults(world, case):
    results, tparams = world
    per_rank = [r[0][case] for r in results]
    theta, mom, losses, events = _stacked_case(case, tparams)
    for i, r in enumerate(per_rank):
        assert np.array_equal(r["params"], theta[i]), f"{case}: rank {i} theta"
        assert np.array_equal(r["mom"], mom[i]), f"{case}: rank {i} mom"
        np.testing.assert_array_equal(r["losses"], losses[i])
        assert r["events"] == events
    # the fault changed the run: the faulty node's row left its neighbours'
    assert not np.array_equal(theta[2], theta[1])


@pytest.mark.parametrize("case", list(_mask_cases()))
def test_shard_masked_interpreter_matches_reference(world, case):
    results, _ = world
    graph, x, alive, link, bucket = _mask_cases()[case]
    jprog = jsched.compile_graph(getattr(jgraphs, graph[0])(*graph[1:]))
    want = np.asarray(jprog.apply_masked(
        {"w": jnp.asarray(x)}, jnp.asarray(alive),
        link_up=None if link is None else jnp.asarray(link))["w"])
    for rank, r in enumerate(results):
        row, bucketed = r[1][case]
        np.testing.assert_allclose(row, want[rank], atol=1e-6)
        if bucket is not None:
            np.testing.assert_array_equal(bucketed, row)


def test_handoffs_and_member_xi_over_ranks_equal_stacked(world):
    results, _ = world
    adopted = torch.from_numpy(HANDOFF_X.copy())
    tfaults.adopt_neighbor_average(adopted, 1, [0, 2])
    drained = torch.from_numpy(HANDOFF_X.copy())
    tfaults.drain_handoff(drained, 3, [2, 0], HANDOFF_ALIVE)
    xi = float(consensus_distance_masked(torch.from_numpy(HANDOFF_X), HANDOFF_ALIVE != 0))
    for rank, r in enumerate(results):
        got_a, got_d, got_xi = r[2]
        np.testing.assert_array_equal(got_a[0], adopted.numpy()[rank])
        np.testing.assert_array_equal(got_d[0], drained.numpy()[rank])
        assert abs(got_xi - xi) <= 1e-6 * max(1.0, xi)
    # the handoff preserved the global mean over the survivors
    surv = np.array([True, True, True, False])
    np.testing.assert_allclose(drained.numpy()[surv].astype(np.float64).mean(0),
                               HANDOFF_X.astype(np.float64).mean(0), atol=1e-6)
