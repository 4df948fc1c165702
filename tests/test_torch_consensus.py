"""Port parity: consensus distance and the closed-loop controller against
``repro.core.consensus``.

Ξ on the same numpy replicas agrees with the reference within rtol 1e-6
(stacked as a dict of leaves and as a flat buffer, in one chunk and in
many); on 4 gloo ranks the shard Ξ equals the stacked Ξ.  Fed the same
scripted Ξ series (rises, crossings, zero and non-finite probes, spikes,
re-arms), the port's ``ConsensusController`` gives the reference's
``transitions``, ``trace`` and ``events`` lists entry for entry, and its
closed-loop topologies enumerate the reference's programs.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_rank_worker  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import dsgd as jdsgd  # noqa: E402
from repro.core.ada import AdaSchedule as JAda  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import dsgd as tdsgd  # noqa: E402
from repro_torch.core.ada import AdaSchedule as TAda  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402

torch.set_num_threads(1)


def _tree(n=6, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "a": (scale * rng.normal(size=(n, 3, 4))).astype(np.float32),
        "b": (scale * rng.normal(size=(n, 7))).astype(np.float32),
        "c": (1.0 + 0.01 * rng.normal(size=(n, 2, 5))).astype(np.float32),
    }


@pytest.mark.parametrize("chunk", [None, 5], ids=["one-chunk", "chunked"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consensus_distance_matches_reference(seed, chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(tcons, "CHUNK", chunk)
    tree = _tree(seed=seed)
    want_sq = np.asarray(jcons.consensus_sq_stacked(jax.tree.map(jnp.asarray, tree)))
    want = float(jcons.consensus_distance_stacked(jax.tree.map(jnp.asarray, tree)))
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    layout = FlatLayout.of_stacked(ttree)
    flat = layout.flatten(ttree)
    for stacked in (ttree, flat):
        got_sq = tcons.consensus_sq_stacked(stacked)
        assert got_sq.shape == (6,) and got_sq.dtype == torch.float32
        np.testing.assert_allclose(got_sq.numpy(), want_sq, rtol=1e-6)
        np.testing.assert_allclose(float(tcons.consensus_distance_stacked(stacked)), want,
                                   rtol=1e-6)


def test_consensus_distance_of_bfloat16_state_accumulates_in_float32():
    tree = _tree(seed=4)
    bf = {k: torch.from_numpy(v).bfloat16() for k, v in tree.items()}
    as_f32 = {k: jnp.asarray(v.float().numpy()) for k, v in bf.items()}
    want = float(jcons.consensus_distance_stacked(as_f32))
    np.testing.assert_allclose(float(tcons.consensus_distance_stacked(bf)), want, rtol=1e-6)


def test_consensus_distance_zero_for_identical_replicas():
    x = torch.ones((4, 5, 2))
    assert float(tcons.consensus_distance_stacked({"w": x, "b": 3.0 * torch.ones((4, 9))})) == 0.0


def test_shard_distance_on_gloo_ranks_equals_stacked(tmp_path, monkeypatch):
    tree = _tree(n=4, seed=5)
    want_sq = tcons.consensus_sq_stacked({k: torch.from_numpy(v) for k, v in tree.items()})
    want = float(tcons.consensus_distance_stacked({k: torch.from_numpy(v)
                                                   for k, v in tree.items()}))
    res = spawn_world(_torch_rank_worker.consensus_shard, 4, (tree, 5), timeout=120,
                      device="cpu", workdir=tmp_path)
    for r, (sq, xi) in enumerate(res):
        np.testing.assert_allclose(sq, float(want_sq[r]), rtol=1e-6)
        np.testing.assert_allclose(xi, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# The controller, on scripted Ξ series
# ---------------------------------------------------------------------------

def _pair(n=16, k0=4, k_floor="one_peer", **kw):
    j = jcons.ConsensusController(schedule=JAda(n_nodes=n, k0=k0, gamma_k=1.0,
                                                k_floor=k_floor), **kw)
    t = tcons.ConsensusController(schedule=TAda(n_nodes=n, k0=k0, gamma_k=1.0,
                                                k_floor=k_floor), **kw)
    return j, t


def _same(j, t):
    assert t.transitions == j.transitions
    assert t.trace == j.trace
    assert t.events == j.events
    assert (t.rung, t.xi0, t.current, t.handoff_step) == (j.rung, j.xi0, j.current,
                                                           j.handoff_step)
    assert t.state_dict() == j.state_dict()


def _series(seed, steps=120):
    """Rising, decaying and spiking Ξ with zero and non-finite probes."""
    rng = np.random.default_rng(seed)
    xs = []
    level = 1.0
    for s in range(steps):
        if s == 0 or s % 37 == 5:
            xs.append(0.0)
        elif s % 41 == 7:
            xs.append(float("nan") if s % 2 else float("inf"))
        elif s % 29 == 13:
            xs.append(level * float(rng.uniform(3.0, 6.0)))   # a spike
        else:
            level *= float(rng.uniform(0.8, 1.15))
            xs.append(level)
    return xs


CONTROLLERS = {
    "one_peer-0.5": dict(k0=6, target=0.5),
    "one_peer-0.7-spike2": dict(k0=8, target=0.7, spike=2.0),
    "int-floor-3": dict(k0=7, k_floor=3, target=0.6),
    "n6-k0-50-spike1.5": dict(n=6, k0=50, target=0.8, spike=1.5),
    "probe-every-3": dict(k0=5, target=0.6, probe_every=3, spike=3.0),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_controller_matches_reference_on_scripted_series(name, seed):
    j, t = _pair(**CONTROLLERS[name])
    assert t.ladder == j.ladder and t.describe() == j.describe()
    for s, xi in enumerate(_series(seed)):
        if s % 23 == 11:   # membership events re-arm, same-step reasons merge
            for reason in ("crash", "rejoin", "crash"):
                j.rearm(s, reason)
                t.rearm(s, reason)
        if j.should_probe(s):
            assert t.should_probe(s)
            assert t.observe(xi, s) == j.observe(xi, s)
            _same(j, t)
        assert t.rung_at(s) == j.rung_at(s)
        assert t.graph_at(0, s).mixing_matrix().tolist() == j.graph_at(0, s).mixing_matrix().tolist()
        assert t.period_steps() == j.period_steps()
    _same(j, t)
    assert any(r for _, r in t.transitions), "the series never moved the controller"


def test_controller_resume_adopt_reset_and_pinned():
    j, t = _pair(k0=6, target=0.5, spike=2.0)
    for s, xi in enumerate(_series(3, 60)):
        j.observe(xi, s)
        t.observe(xi, s)
    j2, t2 = _pair(k0=6, target=0.5, spike=2.0)
    t2.load_state_dict(t.state_dict())
    j2.load_state_dict(j.state_dict())
    _same(j2, t2)
    for s, xi in enumerate(_series(4, 30), start=60):
        assert t.observe(xi, s) == t2.observe(xi, s) == j.observe(xi, s)
    _same(j, t)
    small_j, small_t = _pair(n=8, k0=3, target=0.5)
    small_j.adopt(j)
    small_t.adopt(t)
    _same(small_j, small_t)
    with t.pinned(len(t.ladder) - 1):
        assert t.one_peer_active
    with pytest.raises(ValueError):
        with t.pinned(99):
            pass
    t.reset()
    assert (t.xi0, t.rung, t.transitions, t.trace, t.events) == (None, 0, [], [], [])


def test_controller_rejects_what_the_reference_rejects():
    for kw in (dict(target=1.5), dict(target=0.0), dict(target=0.5, spike=0.9)):
        with pytest.raises(ValueError):
            _pair(**kw)


def test_make_topology_closed_loop_matches_reference():
    kw = dict(k0=4, k_floor="one_peer", consensus_target=0.5, consensus_probe_every=2)
    jt, tt = jdsgd.make_topology("d_ada", 16, **kw), tdsgd.make_topology("d_ada", 16, **kw)
    assert tt.closed_loop and tt.time_varying and tt.describe() == jt.describe()
    assert tt.controller.probe_every == 2
    jp, tp = jt.distinct_programs(), tt.distinct_programs()
    assert [k for k, _ in tp] == [k for k, _ in jp]
    assert [p.cache_key for _, p in tp] == [p.cache_key for _, p in jp]
    assert tt.controller.rung == 0
    for rounds in (1, 2, 3):
        for step in range(3):
            a = jt.fused_program_at(step=step, rounds=rounds)
            b = tt.fused_program_at(step=step, rounds=rounds)
            assert b.cache_key == a.cache_key
    for name, bad in [("d_ring", dict(consensus_target=0.5)),
                      ("d_ada", dict(consensus_target=1.5)),
                      ("d_ada", dict(gamma_k=1.0, consensus_target=0.5)),
                      ("d_ada", dict(consensus_spike=2.0))]:
        with pytest.raises(ValueError) as je:
            jdsgd.make_topology(name, 8, **bad)
        with pytest.raises(ValueError) as te:
            tdsgd.make_topology(name, 8, **bad)
        assert str(te.value) == str(je.value)


def test_nonfinite_and_zero_probes_never_arm():
    _, t = _pair()
    assert not t.observe(0.0, 0) and not t.observe(math.nan, 1)
    assert t.xi0 is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_identical_random_replicas_give_exactly_zero(dtype):
    """A mean summed in any order need not return the replicas' common
    value; Ξ is taken relative to node 0, so it is exactly 0 and a zero
    probe stays a zero probe."""
    row = torch.from_numpy(np.random.default_rng(3).standard_normal(1000).astype(np.float32))
    for n in (3, 16, 37):
        x = row.to(dtype)[None].expand(n, -1).contiguous()
        assert float(tcons.consensus_distance_stacked(x)) == 0.0
