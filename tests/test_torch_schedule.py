"""Port parity: graphs, mixing programs and topologies against ``repro.core``.

Every topology ``make_topology`` builds, at n ∈ {4, 8}, over two epochs:
the port's programs realize the same W and permute tables exactly, and its
dense and stacked interpreters agree with the reference's within 1e-6 on
the same numpy inputs (float32 accumulation both sides).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dsgd as jdsgd  # noqa: E402
from repro.core import graphs as jgraphs  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro_torch.core import dsgd as tdsgd  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402

torch.set_num_threads(1)

# topologies that make_topology(name, n) builds without extra arguments,
# plus the argument-taking ones with their arguments
CASES = [(name, {}) for name in jdsgd.TOPOLOGIES
         if name not in ("d_ring_lattice", "d_custom")] + [
    ("d_ring_lattice", {"k": 4}),
    ("d_ada", {"k_floor": "one_peer", "gamma_k": 1.0}),
    ("d_custom", {"adjacency": np.asarray(
        [[0, 1, 1, 0], [1, 0, 1, 1], [1, 1, 0, 0], [0, 1, 0, 0]])}),
]


def _programs(mod, name, n, kw):
    return [p for _, p in mod.make_topology(name, n, **kw).distinct_programs(2)]


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name,kw", CASES, ids=lambda c: c if isinstance(c, str) else "")
def test_programs_match_reference(name, kw, n):
    if name == "d_custom" and n != 4:
        kw = {"adjacency": [(i, (i + 3) % n) for i in range(n)] + [(0, 2)]}
    jp, tp = _programs(jdsgd, name, n, kw), _programs(tdsgd, name, n, kw)
    assert [p.name for p in jp] == [p.name for p in tp]
    if name == "c_complete":
        assert jp == tp == []
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3, 5)).astype(np.float32)
    tree = {"a": x, "b": x[:, 0]}
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(j.matrix(), t.matrix())
        assert t.cache_key == j.cache_key
        jt, tt = j.permute_tables(), t.permute_tables()
        assert (jt is None) == (tt is None)
        if jt is not None:
            np.testing.assert_array_equal(jt[0], tt[0])
            np.testing.assert_array_equal(jt[1], tt[1])
        for engine in ("dense", "stacked"):
            want = j.apply({k: jnp.asarray(v) for k, v in tree.items()}, engine=engine)
            got = t.apply({k: torch.from_numpy(v) for k, v in tree.items()}, engine=engine)
            for k in tree:
                np.testing.assert_allclose(
                    got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0,
                    err_msg=f"{t.name} {engine} {k}",
                )


@pytest.mark.parametrize("name,kw", CASES, ids=lambda c: c if isinstance(c, str) else "")
def test_topology_schedule_matches_reference(name, kw):
    """Degrees, periods and descriptions per (epoch, step) agree."""
    n = 8 if name != "d_custom" else 4
    jt, tt = jdsgd.make_topology(name, n, **kw), tdsgd.make_topology(name, n, **kw)
    assert tt.describe() == jt.describe()
    assert tt.time_varying == jt.time_varying
    for epoch in range(3):
        assert tt.period_at(epoch) == jt.period_at(epoch)
        for step in range(4):
            assert tt.degree_at(epoch, step) == jt.degree_at(epoch, step)


@pytest.mark.parametrize("n", [5, 16, 33])
def test_graph_families_and_gaps_match_reference(n):
    for kind, kw in [("ring", {}), ("torus", {}), ("ring_lattice", {"k": 6}),
                     ("exponential", {}), ("complete", {}), ("star", {}),
                     ("one_peer_exponential", {"step": 2}),
                     ("random_matching", {"seed": 1, "round": 3})]:
        jg, tg = jgraphs.make_graph(kind, n, **kw), tgraphs.make_graph(kind, n, **kw)
        np.testing.assert_array_equal(jg.mixing_matrix(), tg.mixing_matrix())
        assert tgraphs.spectral_gap(tg) == jgraphs.spectral_gap(jg)


def test_edge_coloring_and_dense_program_match_reference():
    edges = [(0, 1), (1, 2), (2, 3), (0, 3), (0, 2), (4, 5), (5, 6), (6, 7), (1, 5)]
    assert tsched.edge_coloring(8, edges) == jsched.edge_coloring(8, edges)
    g_t = tgraphs.from_adjacency(edges)
    g_j = jgraphs.from_adjacency(edges)
    dt, dj = tsched.dense_program(g_t), jsched.dense_program(g_j)
    np.testing.assert_array_equal(dt.matrix(), dj.matrix())
    assert dt.permute_tables() is None and dt.cache_key == dj.cache_key


def test_rejects_unported_topology_options():
    # closed-loop Ada is ported: it is a d_ada option, as in the reference
    with pytest.raises(ValueError, match="d_ada"):
        tdsgd.make_topology("d_ring", 4, consensus_target=0.5)
    assert tdsgd.make_topology("d_ada", 4, consensus_target=0.5).closed_loop
    with pytest.raises(ValueError, match="item 3"):
        tdsgd.make_topology("d_ring", 4, fault_model=object())
