"""Port parity: fused and hub-balanced programs, the comm-cost model and the
``core/mixing.py`` façade against ``repro.core``.

Mirrors ``tests/test_mixing.py`` and the fuse/hub cases of
``tests/test_schedule.py``: the port's fused and hub-balanced programs
realize the reference's stage and product matrices within 1e-12 with the
same cache keys; ``program_comm_bytes``, ``program_max_node_bytes`` and
``mixing_comm_bytes`` are equal exactly; ``mix_dense``/``mix_shift`` and the
fused interpreters agree within 1e-6 on the same numpy inputs; on 4 gloo
ranks ``mix_ppermute`` equals the stacked interpreter's rows within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_rank_worker  # noqa: E402
from repro.core import dsgd as jdsgd  # noqa: E402
from repro.core import graphs as jgraphs  # noqa: E402
from repro.core import mixing as jmix  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro_torch.core import dsgd as tdsgd  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.core import mixing as tmix  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402

torch.set_num_threads(1)

PARAM_BYTES = 4 * 1000


def _x(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((n, 3, 5)).astype(np.float32),
            "b": rng.standard_normal((n, 7)).astype(np.float32)}


def _same_program(j, t):
    assert t.name == j.name and t.cache_key == j.cache_key
    np.testing.assert_allclose(t.matrix(), j.matrix(), rtol=0, atol=1e-12)
    assert t.num_collectives == j.num_collectives
    assert tsched.program_comm_bytes(t, PARAM_BYTES) == jsched.program_comm_bytes(j, PARAM_BYTES)
    assert (tsched.program_max_node_bytes(t, PARAM_BYTES)
            == jsched.program_max_node_bytes(j, PARAM_BYTES))
    assert isinstance(t, tsched.FusedProgram) == isinstance(j, jsched.FusedProgram)
    if isinstance(j, jsched.FusedProgram):
        assert len(t.stages) == len(j.stages)
        for js, ts in zip(j.stages, t.stages):
            assert ts.cache_key == js.cache_key
            np.testing.assert_allclose(ts.matrix(), js.matrix(), rtol=0, atol=1e-12)
        assert t.permute_tables() is None
    x = _x(j.n)
    for engine in ("dense", "stacked"):
        want = j.apply({k: jnp.asarray(v) for k, v in x.items()}, engine=engine)
        got = t.apply({k: torch.from_numpy(v) for k, v in x.items()}, engine=engine)
        for k in x:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{t.name} {engine} {k}")


TOPOS = [("d_ring", {}), ("d_torus", {}), ("d_exponential", {}), ("d_complete", {}),
         ("d_one_peer_exp", {}), ("d_random_matching", {"pool": 3}), ("d_star", {}),
         ("d_ring_lattice", {"k": 4}), ("d_ada", {"k_floor": "one_peer", "gamma_k": 1.0}),
         ("d_ada", {"k0": 6, "k_floor": "one_peer", "consensus_target": 0.5})]


@pytest.mark.parametrize("hub", [False, True], ids=["plain", "hub"])
@pytest.mark.parametrize("rounds", [1, 2, 3])
@pytest.mark.parametrize("name,kw", TOPOS, ids=lambda c: c if isinstance(c, str) else "")
def test_fused_programs_match_reference(name, kw, rounds, hub):
    n = 8
    jt, tt = jdsgd.make_topology(name, n, **kw), tdsgd.make_topology(name, n, **kw)
    for epoch in (0, 3):
        for step in range(3):
            j = jt.fused_program_at(step=step, epoch=epoch, rounds=rounds, hub_balance=hub)
            t = tt.fused_program_at(step=step, epoch=epoch, rounds=rounds, hub_balance=hub)
            _same_program(j, t)


@pytest.mark.parametrize("n,rounds", [(8, 2), (8, 3), (16, 4), (16, 7), (5, 2)])
def test_hub_balanced_star_matches_reference(n, rounds):
    j = jsched.hub_balanced_rounds(jsched.compile_graph(jgraphs.make_graph("star", n)), rounds)
    t = tsched.hub_balanced_rounds(tsched.compile_graph(tgraphs.make_graph("star", n)), rounds)
    _same_program(j, t)
    # the hub's per-step peak send drops from Δ·P to ⌈Δ/rounds⌉·P per stage
    for ts in t.stages:
        assert tsched.program_max_node_bytes(ts, PARAM_BYTES) <= -(-(n - 1) // rounds) * PARAM_BYTES


def test_maybe_hub_balanced_and_fuse_rules_match_reference():
    n = 8
    jstar, tstar = (m.compile_graph(g.make_graph("star", n))
                    for m, g in ((jsched, jgraphs), (tsched, tgraphs)))
    jring, tring = (m.compile_graph(g.make_graph("ring", n))
                    for m, g in ((jsched, jgraphs), (tsched, tgraphs)))
    jone = jsched.compile_graph(jgraphs.one_peer_exponential(n, 0))
    tone = tsched.compile_graph(tgraphs.one_peer_exponential(n, 0))
    pairs = {id(jstar): tstar, id(jring): tring, id(jone): tone}
    for progs in ([jstar, jstar], [jstar, jring], [jstar], [jring, jring], [jone, jone]):
        tprogs = [pairs[id(p)] for p in progs]
        j = jsched.maybe_hub_balanced(progs, len(progs))
        t = tsched.maybe_hub_balanced(tprogs, len(tprogs))
        assert (j is None) == (t is None)
        if j is not None:
            _same_program(j, t)
    # nested fusion flattens; one program passes through; mismatched n raise
    nested = tsched.GossipProgram.fuse([tsched.GossipProgram.fuse([tring, tstar]), tring])
    assert len(nested.stages) == 3
    assert tsched.GossipProgram.fuse([tring]) is tring
    with pytest.raises(ValueError):
        tsched.GossipProgram.fuse([])
    with pytest.raises(ValueError):
        tsched.GossipProgram.fuse([tring, tsched.compile_graph(tgraphs.make_graph("ring", 5))])
    with pytest.raises(ValueError):
        tsched.hub_balanced_rounds(tsched.compile_graph(tgraphs.make_graph("complete", n)), 2)
    assert tsched.hub_balanced_rounds(tring, 1) is tring


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("kind,kw", [("ring", {}), ("torus", {}), ("exponential", {}),
                                     ("complete", {}), ("star", {}),
                                     ("ring_lattice", {"k": 4}),
                                     ("one_peer_exponential", {"step": 1}),
                                     ("random_matching", {"seed": 2, "round": 1})])
def test_mix_dense_shift_and_comm_bytes_match_reference(kind, kw, n):
    jg, tg = jgraphs.make_graph(kind, n, **kw), tgraphs.make_graph(kind, n, **kw)
    x = _x(n, seed=n)
    w = jg.mixing_matrix()
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    for want, got in ((jmix.mix_dense(jx, w), tmix.mix_dense(tx, w)),
                      (jmix.mix_shift(jx, jg), tmix.mix_shift(tx, tg))):
        for k in x:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)
    one = {k: v[0] for k, v in x.items()}
    assert (tmix.mixing_comm_bytes(tg, {k: torch.from_numpy(v) for k, v in one.items()})
            == jmix.mixing_comm_bytes(jg, {k: jnp.asarray(v) for k, v in one.items()}))
    # a single tensor is a tree of one leaf
    np.testing.assert_allclose(tmix.mix_shift(tx["b"], tg).numpy(),
                               np.asarray(jmix.mix_shift(jx["b"], jg)), rtol=0, atol=1e-6)


def test_mixing_preserves_mean_and_reaches_consensus():
    g = tgraphs.make_graph("ring", 8)
    x = torch.from_numpy(_x(8)["b"])
    y = x
    for _ in range(200):
        y = tmix.mix_shift(y, g)
    np.testing.assert_allclose(y.mean(0).numpy(), x.mean(0).numpy(), atol=1e-5)
    assert float((y - y.mean(0)).abs().max()) < 1e-4


def test_mix_ppermute_on_gloo_ranks_matches_stacked(tmp_path):
    n = 4
    x = _x(n, seed=9)["a"]
    cases = {
        "ring": (("make_graph", "ring", n), x, {}),
        "star": (("make_graph", "star", n), x, {}),
        "complete": (("make_graph", "complete", n), x, {}),
        "complete-unrolled": (("make_graph", "complete", n), x,
                              {"complete_as_allreduce": False}),
        "one-peer": (("one_peer_exponential", n, 1), x, {}),
    }
    res = spawn_world(_torch_rank_worker.mix_ppermute_cases, n, (cases,), timeout=120,
                      device="cpu", workdir=tmp_path)
    for name, (graph, xs, _) in cases.items():
        g = getattr(tgraphs, graph[0])(*graph[1:])
        want = tmix.mix_shift(torch.from_numpy(xs), g).numpy()
        got = np.stack([r[name] for r in res])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)
