"""Port parity: the kernels' plain twins against the reference kernels.

On the CPU every wrapper takes its kernel's plain twin; the reference runs
its Pallas kernels in interpret mode, as ``tests/test_kernels.py`` does.
Inputs are numpy arrays from a seed, handed to both sides in float32.

Tolerances: the fused update agrees within atol 1e-6 (both accumulate in
float32 in the same order, up to XLA's and PyTorch's rounding of the same
expressions); the one-node update (K2's twin) at the reference kernel
test's own bounds (θ' 1e-5 in float32 and 2e-2 in bfloat16, m' 1e-5); the
norms within rtol 1e-5 (float32 sums in different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dbench as jdbench  # noqa: E402
from repro.core import graphs as jgraphs  # noqa: E402
from repro.core.schedule import compile_graph as jcompile  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.gossip_update import fused_apply_stacked as j_fused  # noqa: E402
from repro.kernels.gossip_update import gossip_update as j_gossip_update  # noqa: E402
from repro_torch.core import dbench as tdbench  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402
from repro_torch.core.schedule import compile_graph as tcompile  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.gossip_update import fused_apply_stacked as t_fused  # noqa: E402
from repro_torch.kernels.gossip_update import gossip_update, gossip_update_plain  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402

torch.set_num_threads(1)

IRREGULAR = [(0, 1), (1, 2), (2, 3), (0, 3), (0, 2), (4, 5), (5, 6), (6, 7)]
GRAPHS = {
    "star": lambda g: g.Star(8),
    "ring": lambda g: g.Ring(8),
    "one_peer": lambda g: g.one_peer_exponential(8, 1),
    "matching": lambda g: g.random_matching(8, seed=3),
    "irregular": lambda g: g.from_adjacency(IRREGULAR),
}


def _inputs(n, seed, with_momentum=True):
    """Stacked leaves with non-block-aligned sizes (33·7 and 10 columns)."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (n, 33, 7), "b": (n, 10)}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    params = {k: mk(s) for k, s in shapes.items()}
    grads = {k: mk(s) for k, s in shapes.items()}
    mom = {k: mk(s) for k, s in shapes.items()} if with_momentum else None
    return params, grads, mom


def _port_fused(prog, params, grads, mom, **kw):
    to_t = lambda tree: {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    layout = FlatLayout.of_stacked(to_t(params))
    theta = layout.flatten(to_t(params))
    grad = layout.flatten(to_t(grads))
    m = None if mom is None else layout.flatten(to_t(mom))
    theta, m = t_fused(prog, theta, grad, m, **kw)
    p_out = {k: v.numpy() for k, v in layout.stacked_views(theta).items()}
    m_out = None if m is None else {k: v.numpy() for k, v in layout.stacked_views(m).items()}
    return p_out, m_out


def _ref_fused(prog, params, grads, mom, **kw):
    to_j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    p, m = j_fused(prog, to_j(params), to_j(grads), () if mom is None else to_j(mom),
                   block=128, **kw)
    return ({k: np.asarray(v) for k, v in p.items()},
            None if m == () else {k: np.asarray(v) for k, v in m.items()})


def _assert_trees(got, want, atol=1e-6):
    assert (got is None) == (want is None)
    if got is None:
        return
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("graph_name", list(GRAPHS))
def test_fused_apply_matches_reference(graph_name):
    """Circulant, matching and edge-colored programs, momentum SGD, post order."""
    jp, tp = jcompile(GRAPHS[graph_name](jgraphs)), tcompile(GRAPHS[graph_name](tgraphs))
    params, grads, mom = _inputs(8, seed=len(graph_name))
    kw = dict(lr=0.07, beta=0.9)
    want_p, want_m = _ref_fused(jp, params, grads, mom, **kw)
    got_p, got_m = _port_fused(tp, params, grads, mom, **kw)
    _assert_trees(got_p, want_p)
    _assert_trees(got_m, want_m)


@pytest.mark.parametrize("case", ["momentumless", "pre", "fault"])
def test_fused_apply_variants_match_reference(case):
    """beta = 0 keeps no momentum state; pre order mixes before descending;
    a fault row masks one edge and gates one node's update (u = 0)."""
    jp, tp = jcompile(jgraphs.Ring(8)), tcompile(tgraphs.Ring(8))
    params, grads, mom = _inputs(8, seed=11, with_momentum=case != "momentumless")
    kw = dict(lr=0.1, beta=0.0 if case == "momentumless" else 0.9)
    if case == "pre":
        kw["mix_order"] = "pre"
    if case == "fault":
        link = np.ones((8, 8), np.float32)
        link[2, 3] = link[3, 2] = 0.0          # one dropped edge
        update = np.ones(8, np.float32)
        update[5] = 0.0                        # one straggler: u = 0
        fault = {"update": update, "alive": np.ones(8, np.float32), "link": link}
        want_p, want_m = _ref_fused(
            jp, params, grads, mom, fault={k: jnp.asarray(v) for k, v in fault.items()}, **kw
        )
        got_p, got_m = _port_fused(tp, params, grads, mom, fault=fault, **kw)
    else:
        want_p, want_m = _ref_fused(jp, params, grads, mom, **kw)
        got_p, got_m = _port_fused(tp, params, grads, mom, **kw)
    _assert_trees(got_p, want_p)
    _assert_trees(got_m, want_m)


def test_fused_apply_matches_dense_oracle_bf16_state():
    """bfloat16 parameters, float32 momentum: the twin equals the optimizer
    update followed by the dense interpreter up to bf16 rounding."""
    from repro_torch.optim.sgd import sgd

    prog = tcompile(tgraphs.Ring(4))
    rng = np.random.default_rng(0)
    theta = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32)).bfloat16()
    grad = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32)).bfloat16()
    mom = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    up, um = sgd(0.9).update({"w": grad}, {"w": mom.clone()}, {"w": theta}, 0.05)
    want = prog.apply_dense(up)["w"].float()
    got, got_m = t_fused(prog, theta.clone(), grad, mom.clone(), lr=0.05, beta=0.9)
    torch.testing.assert_close(got_m, um["w"], rtol=0, atol=1e-6)
    # one bf16 ulp of the result (the oracle rounds θ* before mixing)
    assert (got.float() - want).abs().max() <= 2.0 ** -7 * want.abs().max()


def test_fused_apply_rejects_non_permute_programs():
    theta = torch.ones(8, 16)
    for prog in (tcompile(tgraphs.Complete(8)),):
        with pytest.raises(ValueError, match="PPermute"):
            t_fused(prog, theta, theta, None, lr=0.1, beta=0.0)


def test_wrapper_rejects_bad_operands():
    from repro_torch.kernels.gossip_update import gossip_program_update

    theta = torch.zeros(4, 16)
    srcs = torch.zeros(4, 2, dtype=torch.int32)
    w = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="overlaps"):
        gossip_program_update(theta, theta, srcs, w, theta, torch.zeros(4, 16),
                              lr=0.1, beta=0.9, fault=w)
    with pytest.raises(TypeError, match="float32"):
        gossip_program_update(theta, theta.clone(), srcs, w, theta,
                              torch.zeros(4, 16, dtype=torch.float64),
                              lr=0.1, beta=0.9, fault=w)
    with pytest.raises(ValueError, match="shape"):
        gossip_program_update(theta, theta.clone(), srcs, w[:, :2], theta,
                              torch.zeros(4, 16), lr=0.1, beta=0.9, fault=w)


@pytest.mark.parametrize("r,p", [(1, 512), (7, 3000), (16, 2048)])
def test_l2_norms_match_reference(r, p):
    x = np.random.default_rng(r).standard_normal((r, p)).astype(np.float32)
    want = np.asarray(jops.l2_norms(jnp.asarray(x), block=512))
    got = tops.l2_norms(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(tref.l2_norms_ref(torch.from_numpy(x)).numpy(), want, rtol=1e-5)


def test_param_l2_norms_match_reference_probe():
    """The flat-buffer probe (one segment per leaf, G rows) equals the
    reference's per-node probe in leaf order; empty leaves give 0."""
    rng = np.random.default_rng(5)
    params = {
        "a": rng.standard_normal((3, 37, 11)).astype(np.float32),
        "b": rng.standard_normal((3, 257)).astype(np.float32),
        "c": np.zeros((3, 0), np.float32),
        "d": rng.standard_normal((3, 4, 4)).astype(np.float32),
    }
    want = np.asarray(jax.vmap(jdbench.param_l2_norms)({k: jnp.asarray(v) for k, v in params.items()}))
    tree = {k: torch.from_numpy(v) for k, v in params.items()}
    layout = FlatLayout.of_stacked(tree)
    got = tdbench.param_l2_norms(layout.flatten(tree), layout).numpy()
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="offsets"):
        tops.segment_l2_norms(layout.flatten(tree), (0, 5, 3))


def test_gossip_update_ref_matches_reference():
    from repro.kernels import ref as jref

    rng = np.random.default_rng(2)
    theta, g, m = (rng.standard_normal(500).astype(np.float32) for _ in range(3))
    nbrs = rng.standard_normal((2, 500)).astype(np.float32)
    w = np.full(3, 1 / 3, np.float32)
    jo, jm = jref.gossip_update_ref(*(jnp.asarray(a) for a in (theta, nbrs, w, g, m)),
                                    lr=0.1, beta=0.9)
    to, tm = tref.gossip_update_ref(*(torch.from_numpy(a) for a in (theta, nbrs, w, g, m)),
                                    lr=0.1, beta=0.9)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)


def test_dispersion_metrics_match_reference():
    rng = np.random.default_rng(9)
    norms = rng.random((6, 5)) + 0.5
    jr, tr = jdbench.variance_report(norms), tdbench.variance_report(norms)
    for k in jr:
        np.testing.assert_array_equal(tr[k], jr[k])
    series = {"a": rng.random((4, 5)), "b": rng.random((4, 5)), "c": rng.random((4, 5))}
    for k, v in jdbench.rank_analysis(series).items():
        np.testing.assert_array_equal(tdbench.rank_analysis(series)[k], v)


# ---------------------------------------------------------------------------
# K2: one node's update (the ranks engine's fused apply)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faulty", [False, True], ids=["all-ones", "masked"])
@pytest.mark.parametrize("mix_order", ["post", "pre"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,deg,block", [(1024, 2, 256), (4096, 6, 1024), (2048, 1, 2048)])
def test_gossip_update_twin_matches_reference_kernel(p, deg, block, dtype, mix_order, faulty):
    """K2's plain twin against the reference kernel ``gossip_update`` run
    in interpret mode, on the sweep of ``tests/test_kernels.py``."""
    rng = np.random.default_rng(p + deg)
    theta, g, m = (rng.standard_normal(p).astype(np.float32) for _ in range(3))
    nbrs = rng.standard_normal((deg, p)).astype(np.float32)
    w = rng.dirichlet(np.ones(deg + 1)).astype(np.float32)
    fault = np.ones(deg + 1, np.float32)
    if faulty:
        fault[0] = 0.0   # the node skips its update (u = 0)
        fault[1] = 0.0   # and its first edge is down
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jt, jm = j_gossip_update(
        jnp.asarray(theta).astype(jdt), jnp.asarray(nbrs).astype(jdt), jnp.asarray(w),
        jnp.asarray(g).astype(jdt), jnp.asarray(m), lr=0.1, beta=0.9,
        fault=jnp.asarray(fault), block=block, interpret=True, mix_order=mix_order,
    )
    t = lambda a: torch.from_numpy(a)
    tt, tm = gossip_update_plain(
        t(theta).to(tdt), t(nbrs).to(tdt), t(w), t(g).to(tdt), t(m),
        lr=0.1, beta=0.9, fault=t(fault), mix_order=mix_order,
    )
    assert tt.dtype == tdt and tm.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tt.float().numpy(), np.asarray(jt, np.float32), atol=tol)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)


def test_gossip_update_wrapper_in_place_and_checks():
    """On CPU tensors the wrapper writes the twin's result in place; it
    refuses a landing buffer that aliases θ and mismatched rows."""
    rng = np.random.default_rng(4)
    theta = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    grad, mom = torch.ones(300), torch.zeros(300)
    nbrs = torch.from_numpy(rng.standard_normal((2, 300)).astype(np.float32))
    w = torch.full((3,), 1 / 3)
    want_t, want_m = gossip_update_plain(theta, nbrs, w, grad, mom, lr=0.1, beta=0.9,
                                         fault=torch.ones(3))
    got_t, got_m = gossip_update(theta, nbrs, w, grad, mom, lr=0.1, beta=0.9,
                                 fault=torch.ones(3))
    assert got_t.data_ptr() == theta.data_ptr() and got_m.data_ptr() == mom.data_ptr()
    assert torch.equal(got_t, want_t) and torch.equal(got_m, want_m)
    assert gossip_update.launches == 0   # the twin is no launch
    with pytest.raises(ValueError, match="overlaps"):
        gossip_update(theta, theta.view(1, -1), w[:2], grad, mom, lr=0.1, beta=0.9,
                      fault=torch.ones(2))
    with pytest.raises(ValueError, match="shape"):
        gossip_update(theta, nbrs, w[:2], grad, mom, lr=0.1, beta=0.9, fault=torch.ones(3))


SHARD_GRAPHS = {
    "ring": ("Ring", 4),
    "star": ("Star", 4),
    "matching": ("random_matching", 4, 3),
    "irregular": ("from_adjacency", [(0, 1), (1, 2), (0, 2), (2, 3)]),
}
SHARD_VARIANTS = {
    "post": dict(lr=0.07, beta=0.9),
    "pre": dict(lr=0.07, beta=0.9, mix_order="pre"),
    "momentumless": dict(lr=0.07, beta=0.0),
    "fault": dict(lr=0.07, beta=0.9, fault={
        "update": np.array([1, 1, 0, 1], np.float32),
        "alive": np.ones(4, np.float32),
        "link": np.array([[1, 0, 1, 1], [0, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1]],
                         np.float32),
    }),
}
SHARD_CASES = [(gname, v) for gname in SHARD_GRAPHS for v in SHARD_VARIANTS
               if gname == "ring" or v == "post"]


def _shard_inputs(case):
    rng = np.random.default_rng(len(case[0]) * 7 + len(case[1]))
    mk = lambda: rng.standard_normal((4, 1003)).astype(np.float32)
    theta, grad, mom = mk(), mk(), mk()
    return theta, grad, (None if case[1] == "momentumless" else mom)


@pytest.fixture(scope="module")
def shard_world(tmp_path_factory):
    """``fused_apply_shard`` on every rank of one 4-rank gloo world."""
    cases = {f"{g}-{v}": (SHARD_GRAPHS[g], _shard_inputs((g, v)), SHARD_VARIANTS[v])
             for g, v in SHARD_CASES}
    import _torch_rank_worker

    results = spawn_world(_torch_rank_worker.fused_shard_cases, 4, (cases,), timeout=120,
                          device="cpu", workdir=tmp_path_factory.mktemp("shard"))
    return results


@pytest.mark.parametrize("case", SHARD_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_fused_apply_shard_matches_stacked_rows(shard_world, case):
    """Each rank's K2 path (wire, one permute per op, K2's twin) equals its
    row of ``fused_apply_stacked`` (K1's twin) within 1e-6."""
    g, v = case
    theta, grad, mom = _shard_inputs(case)
    graph = SHARD_GRAPHS[g]
    prog = tcompile(getattr(tgraphs, graph[0])(*graph[1:]))
    want_t, want_m = t_fused(
        prog, torch.from_numpy(theta.copy()), torch.from_numpy(grad),
        None if mom is None else torch.from_numpy(mom.copy()), **SHARD_VARIANTS[v],
    )
    for rank, res in enumerate(shard_world):
        got_t, got_m = res[f"{g}-{v}"]
        np.testing.assert_allclose(got_t, want_t[rank].numpy(), rtol=0, atol=1e-6)
        if mom is None:
            assert got_m is None
        else:
            np.testing.assert_allclose(got_m, want_m[rank].numpy(), rtol=0, atol=1e-6)
