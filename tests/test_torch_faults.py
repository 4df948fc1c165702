"""Port parity: fault injection (``repro_torch/core/faults.py``, the degraded
and masked programs of ``core/schedule.py``, the masked Ξ) against the
reference's ``repro/core/faults.py``, mirroring ``tests/test_faults.py``.

Both packages get the same numpy-seeded inputs:

* every fault model's realization stream equals the reference's exactly
  (``update``, ``alive``, ``link_up``, ``rejoin``, ``depart``, ``joins``,
  ``program_alive``, ``selection_mask``) over several seeds and sizes;
* ``degrade``, ``degraded_matrix`` and ``apply_masked`` (dense and stacked)
  within 1e-6 of the reference (float masks included); the kernels' fault
  rows equal the reference's and K1's twin realizes the masked oracle;
* the simulator under each fault class (crash with rejoin, concurrent
  composed and enumerated, preempt, join, dropout, link, straggler,
  deadline, spare) equals the reference's: parameters within 5e-5, losses
  within 5e-5 of their size, norms within rtol 1e-5, equal controller
  transitions and events and equal membership events in the telemetry.
"""
import importlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dsgd as jdsgd  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import graphs as jgraphs  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core.consensus import consensus_distance_masked as jxi_masked  # noqa: E402
from repro.core.simulator import DecentralizedSimulator as JSim  # noqa: E402
from repro.telemetry import MemorySink as JSink  # noqa: E402
from repro.telemetry import MetricsRecorder as JRecorder  # noqa: E402
from repro_torch.core import dsgd as tdsgd  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.consensus import (  # noqa: E402
    consensus_distance_masked, consensus_distance_stacked,
)
from repro_torch.core.simulator import DecentralizedSimulator as TSim  # noqa: E402
from repro_torch.kernels import gossip_update as gu  # noqa: E402
from repro_torch.telemetry import MemorySink as TSink  # noqa: E402
from repro_torch.telemetry import MetricsRecorder as TRecorder  # noqa: E402

torch.set_num_threads(1)
joptim = importlib.import_module("repro.optim.sgd")
toptim = importlib.import_module("repro_torch.optim.sgd")

KINDS = [k for k in tfaults.FAULT_MODELS if k != "none"]


def random_connected_edges(n, seed):
    """The edge list of a seeded random connected graph (a random spanning
    path plus random chords), as the reference's tests draw it."""
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


def both_graphs(edges):
    return tgraphs.from_adjacency(edges), jgraphs.from_adjacency(edges)


def masked_apply(prog, x, alive, link=None, engine="stacked"):
    """The port's ``apply_masked`` of numpy ``x`` -> numpy."""
    return prog.apply_masked(torch.from_numpy(x), alive, link_up=link, engine=engine).numpy()


def ref_masked_apply(prog, x, alive, link=None, engine="stacked"):
    link = None if link is None else jnp.asarray(link, jnp.float32)
    out = prog.apply_masked({"w": jnp.asarray(x)}, jnp.asarray(alive, jnp.float32),
                            link_up=link, engine=engine)
    return np.asarray(out["w"])


def assert_same_realization(a, b, label=""):
    """Two realizations (port, reference) are equal field by field."""
    for field in ("alive", "update", "program_alive"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, (label, field)
        np.testing.assert_array_equal(x, y, err_msg=f"{label} {field}")
    assert (a.link_up is None) == (b.link_up is None), label
    if a.link_up is not None:
        np.testing.assert_array_equal(a.link_up, b.link_up, err_msg=label)
    assert (a.rejoin, a.depart, a.joins) == (b.rejoin, b.depart, b.joins), label
    np.testing.assert_array_equal(a.selection_mask(), b.selection_mask(), err_msg=label)
    assert a.membership_key() == b.membership_key() and a.faulty == b.faulty, label


# ---------------------------------------------------------------------------
# Fault models: the reference's streams, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spares", [0, 2], ids=["plain", "spare-pool"])
@pytest.mark.parametrize("kind", KINDS)
@given(st.integers(min_value=5, max_value=13), st.integers(min_value=0, max_value=10_000))
@settings(max_examples=4, deadline=None)
def test_fault_realizations_equal_reference(kind, spares, n, seed):
    kw = dict(rate=0.4, seed=seed, spare_ranks=spares)
    if kind in ("crash", "concurrent"):
        kw["down_steps"] = 3
    if kind == "join":
        kw["join_steps"] = (2, 5) if spares == 0 else (2,)
    got, want = tfaults.make_fault_model(kind, n, **kw), jfaults.make_fault_model(kind, n, **kw)
    assert type(got).__name__ == type(want).__name__
    assert got.describe() == want.describe()
    assert got.program_masks() == want.program_masks()
    assert (got.has_link_faults, got.elastic) == (want.has_link_faults, want.elastic)
    for t in list(range(16)) + [40, 3, 0]:   # out of order too: pure in (seed, t)
        assert_same_realization(got.at(t), want.at(t), f"{kind} n={n} seed={seed} t={t}")


def test_fault_model_kinds_and_validation():
    mk = tfaults.make_fault_model
    assert mk("none", 8) is None
    assert mk("dropout", 8, rate=0.0) is None
    assert isinstance(mk("dropout", 8, rate=0.2), tfaults.TransientDropout)
    assert isinstance(mk("link", 8, rate=0.2), tfaults.LinkFailure)
    assert isinstance(mk("straggler", 8, rate=0.2), tfaults.Straggler)
    crash = mk("crash", 8, rate=0.5, seed=3, down_steps=4)
    assert isinstance(crash, tfaults.PermanentCrash)
    assert crash.rejoin_step == crash.crash_step + 4
    for bad, match in [(dict(kind="cosmic_ray"), "unknown fault model"),
                       (dict(kind="dropout", rate=1.5), "rate"),
                       (dict(kind="dropout", rate=0.2, down_steps=3), "crash"),
                       (dict(kind="crash", rate=0.5, down_steps=0), "down_steps"),
                       (dict(kind="crash", rate=0.5, down_steps=-3), "down_steps")]:
        kw = dict(bad)
        with pytest.raises(ValueError, match=match):
            mk(kw.pop("kind"), 8, **kw)
    with pytest.raises(ValueError, match="decentralized"):
        tdsgd.make_topology("c_complete", 8, fault_model=mk("dropout", 8, rate=0.2))
    with pytest.raises(ValueError, match="covers"):
        tdsgd.make_topology("d_ring", 8, fault_model=mk("dropout", 4, rate=0.2))


def test_fault_semantics_per_class():
    drop = tfaults.TransientDropout(n=16, rate=0.5, seed=1).at(3)
    assert drop.update.all() and not drop.alive.all() and drop.program_alive.all()
    strag = tfaults.Straggler(n=16, rate=0.5, seed=1).at(3)
    assert strag.alive.all() and not strag.update.all()
    link = tfaults.LinkFailure(n=16, rate=0.5, seed=1).at(3)
    np.testing.assert_array_equal(link.link_up, link.link_up.T)
    assert np.diagonal(link.link_up).all()
    arrays = tfaults.realization_arrays(link, "cpu")
    assert arrays["link"].dtype == torch.float32 and arrays["link"].shape == (16, 16)
    assert tfaults.realization_arrays(drop, "cpu")["link"] is None
    crash = tfaults.PermanentCrash(n=16, rate=0.9, seed=1, down_steps=5)
    c = crash.crash_step
    during = crash.at(c)
    assert crash.at(c - 1).alive.all() and not during.alive[crash.victim]
    assert crash.program_masks() == (during.membership_key(),)
    after = crash.at(crash.rejoin_step)
    assert after.alive.all() and after.rejoin == (crash.victim,)


# ---------------------------------------------------------------------------
# Degraded and masked programs
# ---------------------------------------------------------------------------

@given(st.integers(min_value=2, max_value=14), st.integers(min_value=0, max_value=10_000))
@settings(max_examples=25, deadline=None)
def test_degrade_and_masked_interpreters_match_reference(n, seed):
    rng = np.random.default_rng(seed)
    tg, jg = both_graphs(random_connected_edges(n, seed))
    tprog, jprog = tsched.compile_graph(tg), jsched.compile_graph(jg)
    alive = rng.random(n) > 0.35
    if not alive.any():
        alive[int(rng.integers(n))] = True
    want = jfaults.degraded_matrix(jg.mixing_matrix(), alive)
    np.testing.assert_array_equal(tfaults.degraded_matrix(tg.mixing_matrix(), alive), want)
    tdeg, jdeg = tprog.degrade(alive), jprog.degrade(alive)
    assert tdeg.cache_key == jdeg.cache_key
    np.testing.assert_allclose(tdeg.matrix(), want, atol=1e-12)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    for engine in ("dense", "stacked"):
        got = tdeg.apply(torch.from_numpy(x), engine=engine).numpy()
        np.testing.assert_allclose(got, want @ x, atol=1e-6, err_msg=engine)
        got_m = masked_apply(tprog, x, alive, engine=engine)
        np.testing.assert_allclose(got_m, ref_masked_apply(jprog, x, alive, engine=engine),
                                   atol=1e-6, err_msg=engine)
        np.testing.assert_allclose(got_m, want @ x, atol=1e-6, err_msg=engine)


def test_degrade_caches_and_noops_when_all_alive():
    prog = tsched.compile_graph(tgraphs.Ring(8))
    assert prog.degrade(np.ones(8, bool)) is prog
    alive = np.ones(8, bool)
    alive[3] = False
    a, b = prog.degrade(alive), prog.degrade(alive)
    assert a is b and a.cache_key != prog.cache_key
    assert a.cache_key == jsched.compile_graph(jgraphs.Ring(8)).degrade(alive).cache_key
    with pytest.raises(ValueError, match="alive mask"):
        prog.degrade(np.ones(5, bool))


def test_degrade_nonpermute_and_fused_programs_match_reference():
    alive = np.ones(6, bool)
    alive[0] = False
    tprog = tsched.compile_graph(tgraphs.Complete(6))
    deg = tprog.degrade(alive)
    assert any(isinstance(op, tsched.GatherRow) for op in deg.ops)
    jdeg = jsched.compile_graph(jgraphs.Complete(6)).degrade(alive)
    assert deg.cache_key == jdeg.cache_key
    np.testing.assert_allclose(deg.matrix(), jdeg.matrix(), atol=1e-12)
    # a fused program degrades stage by stage, as the reference's
    t_topo, j_topo = tdsgd.make_topology("d_one_peer_exp", 6), jdsgd.make_topology(
        "d_one_peer_exp", 6)
    tf = t_topo.fused_program_at(step=0, rounds=2).degrade(alive)
    jf = j_topo.fused_program_at(step=0, rounds=2).degrade(alive)
    assert tf.cache_key == jf.cache_key
    np.testing.assert_allclose(tf.matrix(), jf.matrix(), atol=1e-12)
    x = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    tfused = t_topo.fused_program_at(step=0, rounds=2)
    jfused = j_topo.fused_program_at(step=0, rounds=2)
    boost = np.where(alive, 1.0, 0.0)
    boost[3] = 1.5
    np.testing.assert_allclose(masked_apply(tfused, x, boost), ref_masked_apply(jfused, x, boost),
                               atol=1e-6)


def test_apply_masked_link_failures_and_boost_match_reference():
    tg, jg = both_graphs(random_connected_edges(10, 5))
    tprog, jprog = tsched.compile_graph(tg), jsched.compile_graph(jg)
    rng = np.random.default_rng(0)
    up = np.triu(rng.random((10, 10)) > 0.4, 1)
    link = up | up.T
    np.fill_diagonal(link, True)
    alive = np.ones(10)
    alive[4] = 1.5   # a drain boost
    x = rng.normal(size=(10, 3)).astype(np.float32)
    want = jfaults.degraded_matrix(jg.mixing_matrix(), alive, link) @ x
    for engine in ("dense", "stacked"):
        got = masked_apply(tprog, x, alive, link.astype(np.float32), engine)
        np.testing.assert_allclose(got, ref_masked_apply(jprog, x, alive, link, engine),
                                   atol=1e-6)
        np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# The kernels' fault rows
# ---------------------------------------------------------------------------

def test_fault_rows_equal_reference_and_realize_masked_oracle():
    """The kernel fault rows (update, per-edge factors) equal the
    reference's, boost and ghost rows included, and K1's twin on them is
    the masked update followed by the degraded mix."""
    from repro.kernels.gossip_update import _fault_rows_stacked

    rng = np.random.default_rng(3)
    for graph in ("Star", "Ring"):
        tprog = tsched.compile_graph(getattr(tgraphs, graph)(8))
        jprog = jsched.compile_graph(getattr(jgraphs, graph)(8))
        update = np.array([1, 1, 0, 1, 1, 1, 0, 0], np.float32)
        alive = np.array([1, 0, 1, 1, 1.5, 1, 1, 0], np.float32)   # boost, dead, ghost
        link = (rng.random((8, 8)) > 0.2).astype(np.float32)
        link = np.maximum(link, link.T)
        fault = {"update": update, "alive": alive, "link": link}
        rows = gu.fault_rows(tprog, fault, "cpu").numpy()
        want = np.asarray(_fault_rows_stacked(
            {k: jnp.asarray(v) for k, v in fault.items()}, jprog.permute_tables()[0], 8))
        np.testing.assert_array_equal(rows, want)
        th, g, m = (rng.normal(size=(8, 50)).astype(np.float32) for _ in range(3))
        theta, mom = torch.from_numpy(th.copy()), torch.from_numpy(m.copy())
        gu.fused_apply_stacked(tprog, theta, torch.from_numpy(g), mom, lr=0.07, beta=0.9,
                               fault={k: torch.from_numpy(v) for k, v in fault.items()})
        m_want = np.where(update[:, None] > 0, 0.9 * m + g, m)
        theta_star = np.where(update[:, None] > 0, th - 0.07 * m_want, th)
        mixed = jfaults.degraded_matrix(jprog.matrix(), alive, link) @ theta_star
        np.testing.assert_allclose(theta.numpy(), mixed, atol=1e-5)
        np.testing.assert_allclose(mom.numpy(), m_want, atol=1e-6)
        # ghosts (alive 0, update 0) stay exactly where they were
        np.testing.assert_array_equal(theta.numpy()[7], th[7])


# ---------------------------------------------------------------------------
# The simulator under faults
# ---------------------------------------------------------------------------

N, D, STEPS = 8, 6, 12


def _jloss(p, b):
    return jnp.mean(jnp.sum((b["obs"] - p["w"]) ** 2, -1))


def _tloss(p, b):
    return torch.mean(torch.sum((b["obs"] - p["w"]) ** 2, -1))


def quad_batch(rng, n):
    return {"obs": (np.arange(D) + rng.standard_normal((n, 4, D))).astype(np.float32)}


# name -> (fault kind, make_fault_model kwargs): every class, crash with a rejoin
CLASSES = {
    "crash": ("crash", dict(rate=0.5, seed=1, down_steps=3)),
    "concurrent": ("concurrent", dict(rate=0.4, seed=2, k=2, down_steps=3)),
    "concurrent-enumerated": ("concurrent", dict(rate=0.4, seed=2, k=2, down_steps=3,
                                                 enumerate_programs=True)),
    "preempt": ("preempt", dict(rate=0.4, seed=1, drain_steps=3)),
    "join": ("join", dict(rate=0.0, seed=1, join_steps=(3, 6))),
    "dropout": ("dropout", dict(rate=0.3, seed=2)),
    "link": ("link", dict(rate=0.3, seed=2)),
    "straggler": ("straggler", dict(rate=0.3, seed=2)),
    "deadline": ("deadline", dict(rate=0.5, seed=4)),
    "spare": ("join", dict(rate=0.0, seed=1, join_steps=(4,), spare_ranks=2)),
}
# the closed loop, so that membership changes re-arm the controller
ADA = dict(k0=4, k_floor="one_peer", consensus_target=0.5)


def run_sim(lib, kind, kw, *, topology="d_ada", topo_kw=ADA, mixing="dense", steps=STEPS,
            lr=0.05):
    """(params (n, D), [losses], [norms], controller, telemetry events, fault model)."""
    dsgd, faults, Sim, opt, loss, Rec, Sink = (
        (jdsgd, jfaults, JSim, joptim, _jloss, JRecorder, JSink) if lib == "ref"
        else (tdsgd, tfaults, TSim, toptim, _tloss, TRecorder, TSink))
    fm = faults.make_fault_model(kind, N, **kw)
    topo = dsgd.make_topology(topology, N, fault_model=fm, **topo_kw)
    sink = Sink()
    extra = {"device": "cpu"} if lib == "port" else {}
    sim = Sim(loss, opt.sgd(momentum=0.9), topo, mixing=mixing, collect_norms=True,
              telemetry=Rec(sinks=[sink]), **extra)
    state = sim.init({"w": np.full(D, 0.3, np.float32)})
    rng = np.random.default_rng(0)
    losses, norms = [], []
    for t in range(steps):
        b = quad_batch(rng, fm.n_at(t) if hasattr(fm, "n_at") else N)
        if lib == "ref":
            b = {k: jnp.asarray(v) for k, v in b.items()}
        state, loss, nrm = sim.train_step(state, b, lr)
        losses.append(np.asarray(loss))
        norms.append(np.asarray(nrm))
    events = [(r["step"], r["name"], r.get("data")) for r in sink.records
              if r["kind"] == "event"]
    return (np.asarray(state.params["w"]), losses, norms, sim.topology.controller, events, fm)


def check_against_reference(got, want):
    gp, gl, gn, gctl, gev, _ = got
    wp, wl, wn, wctl, wev, _ = want
    assert gp.shape == wp.shape
    assert float(np.abs(gp - wp).max()) < 5e-5
    for a, b in zip(gl, wl):
        assert (np.abs(a - b) <= 5e-5 * np.maximum(1.0, np.abs(b))).all()
    for a, b in zip(gn, wn):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    if wctl is not None:
        assert gctl.events == wctl.events and gctl.transitions == wctl.transitions
    assert gev == wev


@pytest.mark.parametrize("mixing", ["dense", "shift"])
@pytest.mark.parametrize("name", list(CLASSES))
def test_simulator_matches_reference_under_each_fault_class(name, mixing):
    kind, kw = CLASSES[name]
    want = run_sim("ref", kind, kw, mixing=mixing)
    got = run_sim("port", kind, kw, mixing=mixing)
    check_against_reference(got, want)
    fm = got[-1]
    realized = [fm.at(t) for t in range(STEPS)]
    assert any(fr.faulty or fr.rejoin or fr.joins or fr.depart for fr in realized), name


def test_straggler_skips_update_but_still_mixes():
    n = 4
    prog = tsched.compile_graph(tgraphs.Ring(n))

    class OneStraggler(tfaults.Straggler):
        def at(self, step):
            fr = super().at(step)
            update = np.ones(n, bool)
            update[2] = False
            object.__setattr__(fr, "update", update)
            return fr

    topo = tdsgd.make_topology("d_ring", n, fault_model=OneStraggler(n=n, rate=0.0))
    sim = TSim(_tloss, toptim.sgd(momentum=0.9), topo, device="cpu")
    rng = np.random.default_rng(0)
    state = sim.init({"w": np.zeros(D, np.float32)})
    state.theta.copy_(torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32)))
    params0 = state.theta.numpy().copy()
    b = quad_batch(rng, n)
    state, *_ = sim.train_step(state, b, 0.1)
    g = 2 * (params0[:, None, :] - b["obs"]).mean(1)
    theta_star = params0 - 0.1 * g
    theta_star[2] = params0[2]
    np.testing.assert_allclose(state.theta.numpy(), prog.matrix() @ theta_star, atol=1e-5)
    mom = state.opt["mom"].numpy()
    np.testing.assert_array_equal(mom[2], 0.0)
    assert np.abs(mom[[0, 1, 3]]).max() > 1e-3


def test_crash_freezes_victim_and_rejoin_adopts_neighbor_average():
    fm = tfaults.make_fault_model("crash", N, rate=0.5, seed=1, down_steps=4)
    topo = tdsgd.make_topology("d_ring", N, fault_model=fm)
    assert len({p.cache_key for _, p in topo.distinct_programs()}) == 2
    sim = TSim(_tloss, toptim.sgd(momentum=0.9), topo, device="cpu")
    state = sim.init({"w": np.zeros(D, np.float32)})
    v, rng = fm.victim, np.random.default_rng(1)
    checked = False
    for t in range(fm.rejoin_step + 2):
        prev = state.theta.numpy().copy()
        state, *_ = sim.train_step(state, quad_batch(rng, N), 0.05)
        if fm.crash_step <= t < fm.rejoin_step:
            np.testing.assert_array_equal(state.theta.numpy()[v], prev[v])
        if t == fm.rejoin_step:
            buf = torch.from_numpy(prev.copy())
            tfaults.adopt_neighbor_average(buf, v, [(v - 1) % N, (v + 1) % N])
            np.testing.assert_allclose(buf.numpy()[v], prev[[(v - 1) % N, (v + 1) % N]].mean(0),
                                       atol=1e-6)
            checked = True
    assert checked


def test_distinct_programs_fold_degraded_variants_as_reference():
    for kind, kw in [("crash", dict(rate=0.5, seed=1)), ("preempt", dict(rate=0.5, seed=1)),
                     ("concurrent", dict(rate=0.5, seed=2, k=3, down_steps=2,
                                         enumerate_programs=True)),
                     ("join", dict(rate=0.0, join_steps=(2, 3)))]:
        for topology in ("d_ring", "d_one_peer_exp", "d_star"):
            progs = []
            for dsgd, faults in ((tdsgd, tfaults), (jdsgd, jfaults)):
                topo = dsgd.make_topology(topology, 8,
                                          fault_model=faults.make_fault_model(kind, 8, **kw))
                progs.append([(k, p.cache_key) for k, p in topo.distinct_programs(2)])
                assert topo.describe().endswith(f"[faults: {topo.fault_model.describe()}]")
            assert progs[0] == progs[1], (kind, topology)


def test_controller_rearms_on_membership_change():
    fm_kw = dict(rate=0.9, seed=4, down_steps=3)
    got = run_sim("port", "crash", fm_kw, topo_kw=dict(k0=4, k_floor="one_peer",
                                                       consensus_target=0.5), lr=0.2)
    want = run_sim("ref", "crash", fm_kw, topo_kw=dict(k0=4, k_floor="one_peer",
                                                       consensus_target=0.5), lr=0.2)
    fm, ctl = got[-1], got[3]
    events = dict(ctl.events)
    assert fm.crash_step in events and fm.rejoin_step in events
    assert ctl.events == want[3].events
    # Ξ of identical replicas: exactly 0 in the port, a rounding residue in
    # the reference (ROADMAP §3); the probes agree within 1e-6 otherwise
    for (s1, x1, r1), (s2, x2, r2) in zip(ctl.trace, want[3].trace):
        assert (s1, r1) == (s2, r2) and abs(x1 - x2) <= 1e-6 * max(1.0, abs(x2))


def test_consensus_distance_masked_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 19)).astype(np.float32)
    alive = np.array([1, 0, 1, 1, 0, 1], np.float32)
    want = float(jxi_masked({"a": jnp.asarray(x[:, :12]), "b": jnp.asarray(x[:, 12:])},
                            jnp.asarray(alive)))
    got = float(consensus_distance_masked(torch.from_numpy(x), alive))
    assert abs(got - want) <= 1e-6 * max(want, 1.0)
    sub = x[alive > 0].astype(np.float64)
    assert abs(got - np.sqrt(((sub - sub.mean(0)) ** 2).sum(1).mean())) <= 1e-5
    every = float(consensus_distance_masked(torch.from_numpy(x), np.ones(6)))
    assert abs(every - float(consensus_distance_stacked(torch.from_numpy(x)))) <= 1e-6
    same = torch.from_numpy(np.tile(x[:1], (6, 1)))
    assert float(consensus_distance_masked(same, alive)) == 0.0


def test_comm_bytes_skip_dead_edges_as_reference():
    P = 4096
    tstar, jstar = tsched.compile_graph(tgraphs.Star(8)), jsched.compile_graph(jgraphs.Star(8))
    rng = np.random.default_rng(2)
    masks = [None, np.array([0, 1, 1, 1, 1, 1, 1, 1], bool), np.array([1, 1, 1, 0, 1, 1, 1, 1],
                                                                       bool)]
    up = np.triu(rng.random((8, 8)) > 0.3, 1)
    links = [None, up | up.T | np.eye(8, dtype=bool)]
    for alive in masks:
        for link in links:
            for tprog, jprog in ((tstar, jstar), (tsched.compile_graph(tgraphs.Ring(8)),
                                                  jsched.compile_graph(jgraphs.Ring(8)))):
                for fn in ("program_comm_bytes", "program_max_node_bytes"):
                    assert getattr(tsched, fn)(tprog, P, alive=alive, link_up=link) == getattr(
                        jsched, fn)(jprog, P, alive=alive, link_up=link)
    hub_dead = masks[1]
    assert tsched.program_comm_bytes(tstar, P, alive=hub_dead) == 0
    assert tsched.program_comm_bytes(tstar.degrade(hub_dead), P) == 0


def test_fault_run_comm_counters_equal_reference():
    """The recorder bills each realization's surviving edges: the comm
    counters of a link-failure run equal the reference's."""
    counters = []
    for lib in ("port", "ref"):
        dsgd, faults, Sim, opt, loss, Rec, Sink = (
            (jdsgd, jfaults, JSim, joptim, _jloss, JRecorder, JSink) if lib == "ref"
            else (tdsgd, tfaults, TSim, toptim, _tloss, TRecorder, TSink))
        topo = dsgd.make_topology("d_ring", N, fault_model=faults.make_fault_model(
            "link", N, rate=0.4, seed=3))
        sink = Sink()
        sim = Sim(loss, opt.sgd(momentum=0.9), topo, telemetry=Rec(sinks=[sink]),
                  **({"device": "cpu"} if lib == "port" else {}))
        state = sim.init({"w": np.zeros(D, np.float32)})
        rng = np.random.default_rng(0)
        for _ in range(5):
            b = quad_batch(rng, N)
            state, *_ = sim.train_step(state, b if lib == "port" else {
                k: jnp.asarray(v) for k, v in b.items()}, 0.05)
        counters.append([(r["step"], r["name"], r["inc"]) for r in sink.records
                         if r["kind"] == "counter"])
    assert counters[0] == counters[1]
    full = 5 * tsched.program_comm_bytes(tsched.compile_graph(tgraphs.Ring(N)), D * 4)
    assert sum(inc for _, name, inc in counters[0] if name == "comm_bytes") < full
