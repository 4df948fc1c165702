"""Port parity: bucketed gossip (``repro_torch/core/buckets.py``) against the
reference's ``repro/core/buckets.py`` and against the port's own
monolithic step.

Mirrors ``tests/test_buckets.py`` (all but its fault cases, which come with
the fault slice):

* ``BucketLayout``: bounds, widths and segments equal the reference's for
  the same leaf sizes and ``bucket_mb``; bucket views tile the flat buffer
  and share its storage; at most two widths;
* the bucketed interpreters equal the monolithic ones and the dense
  matrix (1e-6), the shard one on 4 gloo ranks too, and the identity
  program short-circuits;
* the per-bucket step against a float64 SGD-then-mix oracle for every
  SGD flavour, with the Ξ² fold equal to the whole state's (rtol 1e-5);
* K1's plain twin on a strided column slice equals it on a contiguous
  copy, and ``fused_bucket_update`` over every bucket equals
  ``fused_apply_stacked`` over the whole state, bit for bit;
* the bucketed simulator and stacked trainer (interpreter and fused)
  equal their monolithic selves bit for bit, the simulator the reference
  simulator's bucketed path within 5e-5; closed-loop d_ada takes the same
  transitions bucketed and monolithic, its folded Ξ within rtol 1e-5 of
  the standalone probe;
* the eligibility gates, and faults raising with their ROADMAP item.
"""
import dataclasses
import importlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import buckets as jbuckets  # noqa: E402
from repro.core.dsgd import make_topology as jmake_topology  # noqa: E402
from repro.core.graphs import from_adjacency as jfrom_adjacency  # noqa: E402
from repro.core.schedule import compile_graph as jcompile_graph  # noqa: E402
from repro.core.simulator import DecentralizedSimulator as JSim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.buckets import (  # noqa: E402
    BucketLayout, bucket_eligible_optimizer, build_bucket_step, xi_from_folded_sq,
)
from repro_torch.core.consensus import (  # noqa: E402
    consensus_distance_stacked, consensus_sq_stacked,
)
from repro_torch.core.dsgd import make_topology  # noqa: E402
from repro_torch.core.graphs import Ring, from_adjacency  # noqa: E402
from repro_torch.core.schedule import compile_graph, identity_program  # noqa: E402
from repro_torch.core.simulator import DecentralizedSimulator  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import gossip_update as gu  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.optim.sgd import adamw, lars, sgd  # noqa: E402

torch.set_num_threads(1)
jsgd = importlib.import_module("repro.optim.sgd").sgd


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


def _random_connected_graph(n, seed):
    return from_adjacency(_random_edges(n, seed))


# ---------------------------------------------------------------------------
# BucketLayout: the reference's partition, as column views
# ---------------------------------------------------------------------------

@given(
    st.integers(min_value=1, max_value=10),
    st.integers(min_value=1, max_value=40),
    st.integers(min_value=0, max_value=10_000),
)
@settings(max_examples=40, deadline=None)
def test_layout_equals_reference_and_tiles_the_buffer(n_leaves, bucket_elems, seed):
    """Bounds, widths and segments equal the reference's; the views tile
    [0, P) exactly, share the buffer's storage and take <= 2 widths."""
    rng = np.random.default_rng(seed)
    sizes = tuple(int(rng.integers(0, 30)) for _ in range(n_leaves))
    got, want = BucketLayout(sizes, bucket_elems), jbuckets.BucketLayout(sizes, bucket_elems)
    assert got.bounds == want.bounds and got.widths == want.widths
    assert got.segments == want.segments and got.num_buckets == want.num_buckets
    assert got.describe() == want.describe()
    assert len(set(got.widths)) <= 2 and sum(got.widths) == sum(sizes)
    buf = torch.arange(3 * max(sum(sizes), 1), dtype=torch.float32).reshape(3, -1)
    if sum(sizes) == 0:
        return
    views = got.views(buf)
    assert [tuple(v.shape) for v in views] == [(3, w) for w in got.widths]
    assert all(v.data_ptr() == buf[:, a:].data_ptr() for v, a in zip(views, got.bounds))
    assert torch.equal(torch.cat(views, dim=1), buf)


@pytest.mark.parametrize("bucket_mb", [1e-5, 3e-5, 1e-4, 1.0])
def test_layout_for_granite_leaves_equals_reference(bucket_mb):
    """The reduced granite-8b leaf sizes, with buckets crossing leaves and
    a ragged tail, from stacked and local trees alike."""
    cfg = get_config("granite-8b-reduced")
    from repro_torch.models import transformer as tfm

    defs = tfm.model_defs(cfg)
    stacked = {k: torch.empty((4,) + d.shape, device="meta") for k, d in defs.items()}
    local = {k: torch.empty(d.shape, device="meta") for k, d in defs.items()}
    got = BucketLayout.for_stacked(stacked, bucket_mb)
    assert got == BucketLayout.for_local(local, bucket_mb)
    jstacked = {k: jnp.zeros((4,) + tuple(v.shape[1:])) for k, v in stacked.items()}
    want = jbuckets.BucketLayout.for_stacked(jstacked, bucket_mb)
    assert got.bounds == want.bounds and got.segments == want.segments
    assert BucketLayout.elems_for_mb(bucket_mb) == jbuckets.BucketLayout.elems_for_mb(bucket_mb)


def test_layout_rejects_a_mismatched_buffer():
    layout = BucketLayout((6,), 4)
    with pytest.raises(ValueError, match="does not match layout"):
        layout.views(torch.zeros(4, 7))
    with pytest.raises(ValueError, match="bucket_elems"):
        BucketLayout((6,), 0)
    assert BucketLayout.elems_for_mb(1.0) == (1 << 20) // 4
    assert BucketLayout.elems_for_mb(1e-9) == 1


# ---------------------------------------------------------------------------
# Bucketed interpreters == monolithic == dense oracle
# ---------------------------------------------------------------------------

@given(
    st.integers(min_value=2, max_value=14),
    st.integers(min_value=0, max_value=10_000),
    st.integers(min_value=1, max_value=20),
)
@settings(max_examples=30, deadline=None)
def test_bucketed_apply_matches_monolithic_and_dense_oracle(n, seed, be):
    rng = np.random.default_rng(seed)
    prog = compile_graph(_random_connected_graph(n, seed))
    x = rng.normal(size=(n, 23)).astype(np.float32)
    layout = BucketLayout((5, 11, 7), be)
    got = prog.apply_stacked_bucketed(torch.from_numpy(x), layout)
    mono = prog.apply_stacked(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), mono.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), prog.matrix() @ x, atol=1e-5)


def test_shard_bucketed_apply_matches_shard_and_stacked(tmp_path):
    """``apply_shard_bucketed`` on 4 gloo ranks, one chain of collectives
    per bucket: ``apply_shard`` and the stacked interpreter's rows within
    1e-6 (the reference's bar: gloo's all-reduce sums a buffer in an order
    that depends on its length), bit for bit for the permute program."""
    import _torch_rank_worker
    from repro_torch.core import graphs
    from repro_torch.launch.comm import spawn_world

    x = np.random.default_rng(5).normal(size=(4, 23)).astype(np.float32)
    cases = {name: (graph, x, (5, 11, 7), 4) for name, graph in (
        ("ring", ("Ring", 4)), ("complete", ("Complete", 4)), ("star", ("Star", 4)))}
    res = spawn_world(_torch_rank_worker.shard_bucketed_cases, 4, (cases,), timeout=120,
                      device="cpu", workdir=tmp_path)
    for name, (graph, *_rest) in cases.items():
        prog = compile_graph(getattr(graphs, graph[0])(*graph[1:]))
        want = prog.apply_stacked(torch.from_numpy(x)).numpy()
        for rank, r in enumerate(res):
            got, mono = r[name]
            if name == "ring":
                np.testing.assert_array_equal(got, mono)
            np.testing.assert_allclose(got, mono, atol=1e-6)
            np.testing.assert_allclose(got, want[rank], atol=1e-6)


def test_bucketed_apply_identity_program_shortcircuits():
    prog = identity_program(4)
    layout = BucketLayout((6,), 5)
    x = torch.arange(24.0).reshape(4, 6)
    assert prog.apply_stacked_bucketed(x, layout) is x


def test_masked_bucketed_variants_raise_with_the_fault_item():
    """The fault slice ported the masked bucketed variants, which raised
    here before: one bucket at a time they equal ``apply_masked`` (a new
    buffer), with a float boost and a dead node in the mask."""
    prog = compile_graph(Ring(4))
    layout = BucketLayout((6,), 5)
    x = torch.arange(24.0).reshape(4, 6)
    alive = torch.tensor([1.0, 1.5, 0.0, 1.0])
    out = prog.apply_masked_bucketed(x, alive, layout=layout)
    assert out is not x and torch.equal(out, prog.apply_masked(x, alive))


# ---------------------------------------------------------------------------
# The per-bucket step against a float64 SGD + mix oracle
# ---------------------------------------------------------------------------

def _sgd_oracle(theta, mom, grad, lr, hyper):
    beta = hyper.get("momentum", 0.0)
    wd = hyper.get("weight_decay", 0.0)
    nest = hyper.get("nesterov", False)
    t, m, g = (np.asarray(x, np.float64) for x in (theta, mom, grad))
    g = g + wd * t
    new_m = beta * m + g
    step = g + beta * new_m if nest else (new_m if beta else g)
    return t - lr * step, new_m


HYPERS = [
    {"kind": "sgd", "momentum": 0.0, "weight_decay": 0.0, "nesterov": False},
    {"kind": "sgd", "momentum": 0.9, "weight_decay": 0.0, "nesterov": False},
    {"kind": "sgd", "momentum": 0.9, "weight_decay": 1e-3, "nesterov": True},
]


@pytest.mark.parametrize("engine", ["stacked", "dense"])
@pytest.mark.parametrize("hyper", HYPERS)
def test_bucket_step_matches_oracle_and_folds_xi(hyper, engine):
    """Per-bucket step == oracle update then W-mix, in place on column
    views of the flat buffers; the token == Σ_c (x_ic − x̄_c)² of the whole
    post-mix state, and the reference's step gives the same numbers."""
    n, lr = 8, 0.05
    rng = np.random.default_rng(0)
    prog = compile_graph(_random_connected_graph(n, 3))
    theta = rng.normal(size=(n, 17)).astype(np.float32)
    grad = rng.normal(size=(n, 17)).astype(np.float32)
    mom = rng.normal(size=(n, 17)).astype(np.float32)
    has_m = hyper["momentum"] != 0.0
    layout = BucketLayout((17,), 5)
    fn = build_bucket_step(prog, hyper=hyper, has_momentum=has_m, engine=engine)
    t_buf, g_buf, m_buf = (torch.from_numpy(a.copy()) for a in (theta, grad, mom))
    tok = torch.zeros(n)
    moms = layout.views(m_buf) if has_m else [None] * layout.num_buckets
    for tb, mb, gb in zip(layout.views(t_buf), moms, layout.views(g_buf)):
        tok = fn(tb, mb, gb, lr, tok)
    t_star, m_new = _sgd_oracle(theta, mom if has_m else 0 * mom, grad, lr, hyper)
    np.testing.assert_allclose(t_buf.numpy(), prog.matrix() @ t_star, atol=1e-5)
    if has_m:
        np.testing.assert_allclose(m_buf.numpy(), m_new, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tok.numpy(), consensus_sq_stacked(t_buf).numpy(), rtol=1e-5)
    assert xi_from_folded_sq(tok) == pytest.approx(
        float(consensus_distance_stacked(t_buf)), rel=1e-5)
    # the reference's per-bucket step on the same inputs
    jprog = jcompile_graph(jfrom_adjacency(_random_edges(n, 3)))
    jfn = jbuckets.build_bucket_step(jprog, hyper=hyper, has_momentum=has_m)
    jtok = jnp.zeros((n,), jnp.float32)
    out = np.empty_like(theta)
    for lo, hi in zip(layout.bounds[:-1], layout.bounds[1:]):
        args = [jnp.asarray(theta[:, lo:hi])] + ([jnp.asarray(mom[:, lo:hi])] if has_m else [])
        res = jfn(*args, jnp.asarray(grad[:, lo:hi]), lr, jtok)
        out[:, lo:hi], jtok = np.asarray(res[0]), res[-1]
    np.testing.assert_allclose(t_buf.numpy(), out, atol=1e-6)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), rtol=1e-5, atol=1e-6)


def test_bucket_step_without_a_probe_skips_the_fold():
    prog = compile_graph(Ring(4))
    fn = build_bucket_step(prog, hyper=HYPERS[1], has_momentum=True)
    t, g, m = torch.ones(4, 3), torch.ones(4, 3), torch.zeros(4, 3)
    assert fn(t, m, g, 0.1, None) is None


def test_identical_replicas_fold_to_exactly_zero():
    prog = compile_graph(Ring(6))
    fn = build_bucket_step(prog, hyper=HYPERS[1], has_momentum=True)
    row = torch.randn(1, 13, generator=torch.Generator().manual_seed(0))
    t, g, m = row.repeat(6, 1), row.repeat(6, 1), torch.zeros(6, 13)
    tok = torch.zeros(6)
    for cols in BucketLayout((13,), 4).bounds[:-1]:
        tok = fn(t[:, cols:cols + 4], m[:, cols:cols + 4], g[:, cols:cols + 4], 0.1, tok)
    assert torch.equal(tok, torch.zeros(6)) and xi_from_folded_sq(tok) == 0.0


def test_bucket_step_validation_gates():
    prog = compile_graph(Ring(4))
    sgd_h = {"kind": "sgd", "momentum": 0.9}
    with pytest.raises(ValueError, match="mix_order"):
        build_bucket_step(prog, hyper=sgd_h, has_momentum=True, mix_order="pre")
    with pytest.raises(ValueError, match="SGD family"):
        build_bucket_step(prog, hyper={"kind": "adamw"}, has_momentum=True)
    with pytest.raises(ValueError, match="plain momentum-SGD"):
        build_bucket_step(prog, hyper={"kind": "sgd", "momentum": 0.9, "weight_decay": 1e-4},
                          has_momentum=True, kernel_split=(prog, ()))
    # the fault-aware step (ported with the fault slice, which raised here
    # before) takes the step's masks; a node with update 0 keeps its row
    fault = {"update": torch.tensor([1.0, 0.0, 1.0, 1.0]), "alive": torch.ones(4),
             "link": None}
    fn = build_bucket_step(prog, hyper=sgd_h, has_momentum=True, fault=fault)
    t, g, m = torch.zeros(4, 3), torch.ones(4, 3), torch.zeros(4, 3)
    fn(t, m, g, 0.1, None)
    assert torch.equal(m[1], torch.zeros(3)) and torch.equal(m[0], torch.ones(3))


def test_bucket_eligibility():
    assert bucket_eligible_optimizer(sgd())
    assert bucket_eligible_optimizer(sgd(momentum=0.0))
    assert not bucket_eligible_optimizer(adamw())
    assert not bucket_eligible_optimizer(lars())


# ---------------------------------------------------------------------------
# K1 on a column slice
# ---------------------------------------------------------------------------

def _k1_inputs(dtype, g=4, p=45, seed=1):
    gen = torch.Generator().manual_seed(seed)
    theta = torch.randn((g, p), generator=gen).to(dtype)
    grad = torch.randn((g, p), generator=gen).to(dtype)
    mom = torch.randn((g, p), generator=gen)
    wire = torch.randn((g, p), generator=gen).to(dtype)
    srcs, w = compile_graph(Ring(g)).permute_tables()
    return theta, grad, mom, wire, torch.from_numpy(srcs), torch.from_numpy(w)


# (lo, hi): a slice inside a leaf with a tail that is no multiple of 8 (the
# kernel's scalar path), one that starts unaligned, and the whole width
@pytest.mark.parametrize("lo,hi", [(8, 29), (3, 40), (0, 45)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mix_order", ["post", "pre"])
def test_k1_twin_on_a_strided_slice_equals_a_contiguous_copy(lo, hi, dtype, mix_order):
    theta, grad, mom, wire, srcs, w = _k1_inputs(dtype)
    fault = torch.ones_like(w)
    fault[1, 0] = 0.0
    kw = dict(lr=0.05, beta=0.9, fault=fault, mix_order=mix_order)
    sl = (slice(None), slice(lo, hi))
    got = gu.gossip_program_update_plain(theta[sl], wire[sl], srcs, w, grad[sl], mom[sl], **kw)
    want = gu.gossip_program_update_plain(theta[sl].contiguous(), wire[sl].contiguous(), srcs,
                                          w, grad[sl].contiguous(), mom[sl].contiguous(), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the wrapper takes the slice in place (row strides checked) and
    # leaves the columns outside it alone
    t2, m2 = theta.clone(), mom.clone()
    gu.gossip_program_update(t2[sl], wire[sl].contiguous(), srcs, w, grad[sl], m2[sl], **kw)
    assert torch.equal(t2[sl], want[0]) and torch.equal(m2[sl], want[1])
    assert torch.equal(t2[:, :lo], theta[:, :lo]) and torch.equal(t2[:, hi:], theta[:, hi:])


def test_k1_wrapper_rejects_mismatched_strides_and_an_aliased_wire():
    theta, grad, mom, wire, srcs, w = _k1_inputs(torch.float32)
    kw = dict(lr=0.05, beta=0.9, fault=torch.ones_like(w))
    wide = torch.zeros(4, 90)
    with pytest.raises(ValueError, match="share one row stride"):
        gu.gossip_program_update(theta, wire, srcs, w, wide[:, :45], mom, **kw)
    with pytest.raises(ValueError, match="contiguous rows"):
        gu.gossip_program_update(theta, wire, srcs, w, grad, torch.zeros(45, 4).t(), **kw)
    with pytest.raises(ValueError, match="overlaps theta"):
        gu.gossip_program_update(theta[:, :20], theta[:, 25:], srcs, w, grad[:, :20],
                                 mom[:, :20], **kw)


@pytest.mark.parametrize("momentum", [0.9, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bucket_update_equals_fused_apply_stacked(dtype, momentum):
    """K1 per bucket on column views == K1 over the whole state, bit for
    bit: the kernel is elementwise per column."""
    theta, grad, mom, _, _, _ = _k1_inputs(dtype, p=53)
    prog = compile_graph(Ring(4))
    whole_t, whole_m = theta.clone(), (mom.clone() if momentum else None)
    gu.fused_apply_stacked(prog, whole_t, grad, whole_m, lr=0.05, beta=momentum)
    bt, bm = theta.clone(), (mom.clone() if momentum else None)
    layout = BucketLayout((20, 33), 12)
    moms = layout.views(bm) if momentum else [None] * layout.num_buckets
    for tb, gb, mb in zip(layout.views(bt), layout.views(grad), moms):
        gu.fused_bucket_update(prog, tb, gb, mb, lr=0.05, beta=momentum)
    assert torch.equal(bt, whole_t)
    if momentum:
        assert torch.equal(bm, whole_m)
    # under faults (the step's kernel fault rows, built once for every
    # bucket) the buckets equal the monolithic faulty apply bit for bit
    fault = {"update": np.array([1, 0, 1, 1], np.float32),
             "alive": np.array([1, 1, 1.5, 0], np.float32), "link": None}
    rows = gu.fault_rows(prog, fault, "cpu")
    whole_t, whole_m = theta.clone(), (mom.clone() if momentum else None)
    gu.fused_apply_stacked(prog, whole_t, grad, whole_m, lr=0.05, beta=momentum, fault=fault)
    bt, bm = theta.clone(), (mom.clone() if momentum else None)
    moms = layout.views(bm) if momentum else [None] * layout.num_buckets
    for tb, gb, mb in zip(layout.views(bt), layout.views(grad), moms):
        gu.fused_bucket_update(prog, tb, gb, mb, lr=0.05, beta=momentum, fault=rows)
    assert torch.equal(bt, whole_t)
    if momentum:
        assert torch.equal(bm, whole_m)


# ---------------------------------------------------------------------------
# End to end: the simulator
# ---------------------------------------------------------------------------

def _lin_loss_t(params, batch):
    y = batch["x"] @ params["w"] + params["b"]
    return torch.mean((y - batch["y"]) ** 2)


def _lin_loss_j(params, batch):
    y = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((y - batch["y"]) ** 2)


def _lin_setup(n, steps, seed=0):
    rng = np.random.default_rng(seed)
    params = {"b": np.zeros((2,), np.float32),
              "w": rng.normal(size=(3, 2)).astype(np.float32)}
    batches = [{"x": rng.normal(size=(n, 4, 3)).astype(np.float32),
                "y": rng.normal(size=(n, 4, 2)).astype(np.float32)} for _ in range(steps)]
    return params, batches


def _sim_run(n, params, batches, topo_name, *, topo_kw=None, **kw):
    topo = make_topology(topo_name, n, **(topo_kw or {}))
    sim = DecentralizedSimulator(_lin_loss_t, sgd(momentum=0.9), topo, device="cpu", **kw)
    state = sim.init(params)
    for t, b in enumerate(batches):
        state, _, _ = sim.train_step(state, b, 0.05)
    return sim, state, topo


@pytest.mark.parametrize("mixing", ["dense", "shift"])
@pytest.mark.parametrize("topo_name", ["d_ring", "d_one_peer_exp"])
def test_simulator_bucketed_equals_monolithic_and_reference(topo_name, mixing):
    """2-element buckets (4 of them over P = 8): bit for bit the monolithic
    simulator, within 5e-5 of the reference's bucketed simulator."""
    n, steps = 8, 6
    params, batches = _lin_setup(n, steps)
    _, mono, _ = _sim_run(n, params, batches, topo_name, mixing=mixing)
    _, buck, _ = _sim_run(n, params, batches, topo_name, mixing=mixing, bucket_mb=1e-5)
    assert torch.equal(mono.theta, buck.theta) and torch.equal(mono.opt["mom"], buck.opt["mom"])
    jsim = JSim(_lin_loss_j, jsgd(momentum=0.9), jmake_topology(topo_name, n), mixing=mixing,
                bucket_mb=1e-5)
    jstate = jsim.init({k: jnp.asarray(v) for k, v in params.items()})
    for b in batches:
        jstate, _, _ = jsim.train_step(jstate, {k: jnp.asarray(v) for k, v in b.items()}, 0.05)
    assert jsim._bucket_layout.num_buckets == 4
    for k, v in buck.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.params[k]), rtol=0, atol=5e-5)


def test_simulator_bucketed_respects_mix_every():
    """Off-cycle steps (mix_every=2) take the plain path; both engines agree."""
    n, steps = 6, 6
    params, batches = _lin_setup(n, steps, seed=9)
    _, mono, _ = _sim_run(n, params, batches, "d_ring", mix_every=2)
    _, buck, _ = _sim_run(n, params, batches, "d_ring", mix_every=2, bucket_mb=2e-5)
    assert torch.equal(mono.theta, buck.theta)


def test_simulator_bucketed_closed_loop_folds_xi():
    """Closed-loop d_ada probing every step: the bucketed run folds Ξ² into
    its buckets (no standalone probe after a bucketed step), takes the
    monolithic run's transitions, and each folded Ξ is within rtol 1e-5
    of the standalone probe on the same state."""
    n, steps = 8, 10
    params, batches = _lin_setup(n, steps, seed=2)
    kw = dict(topo_kw=dict(k_floor="one_peer", consensus_target=0.9), mixing="shift")
    _, mono, mtopo = _sim_run(n, params, batches, "d_ada", **kw)
    sim, buck, btopo = _sim_run(n, params, batches, "d_ada", bucket_mb=1e-5, **kw)
    assert btopo.controller.transitions == mtopo.controller.transitions
    assert mtopo.controller.transitions, "the loop never moved: the test sees nothing"
    assert sim._fold.step == buck.step
    assert xi_from_folded_sq(sim._fold.sq) == pytest.approx(
        float(consensus_distance_stacked(buck.theta)), rel=1e-5)
    for (sa, xa, ra), (sb, xb, rb) in zip(mtopo.controller.trace, btopo.controller.trace):
        assert (sa, ra) == (sb, rb) and xb == pytest.approx(xa, rel=1e-5, abs=1e-12)
    assert torch.equal(mono.theta, buck.theta)


def test_simulator_bucket_validation():
    def sim(opt, topo, **kw):
        return DecentralizedSimulator(_lin_loss_t, opt, topo, bucket_mb=1.0, device="cpu", **kw)

    with pytest.raises(ValueError, match="SGD-family"):
        sim(adamw(), make_topology("d_ring", 4))
    with pytest.raises(ValueError, match="decentralized"):
        sim(sgd(), make_topology("c_complete", 4))
    with pytest.raises(ValueError, match="mix_order"):
        sim(sgd(), make_topology("d_ring", 4, mix_order="pre"))


# ---------------------------------------------------------------------------
# End to end: the stacked trainer
# ---------------------------------------------------------------------------

def _trainer_run(topo_name, *, fused, bucket_mb, dtype=torch.float32, steps=4, topo_kw=None,
                 momentum=0.9, **kw):
    cfg = dataclasses.replace(get_config("granite-8b-reduced"), dtype=dtype)
    topo = make_topology(topo_name, 4, **(topo_kw or {}))
    trainer = SPMDTrainer(cfg, topo, sgd(momentum=momentum), collect_norms=True,
                          fused_apply=fused, bucket_mb=bucket_mb, device="cpu", **kw)
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=16, seed=0)
    losses = []
    for t in range(steps):
        state, loss, _ = trainer.train_step(state, src.stacked(4, t, 2), 0.05)
        losses.append(loss)
    return trainer, state, topo, torch.stack(losses)


# bucket sizes: 551 buckets of 2621 elements (boundaries inside leaves,
# a ragged tail), and one bucket (the whole state)
@pytest.mark.parametrize("bucket_mb", [0.01, 64.0])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["d_ring-bf16", "d_one_peer_exp-rounds2", "d_ring-nomom"])
def test_trainer_bucketed_equals_monolithic(case, fused, bucket_mb):
    kw = {"d_ring-bf16": dict(topo_name="d_ring", dtype=torch.bfloat16),
          "d_one_peer_exp-rounds2": dict(topo_name="d_one_peer_exp", mix_rounds=2),
          "d_ring-nomom": dict(topo_name="d_ring", momentum=0.0)}[case]
    _, mono, _, lm = _trainer_run(fused=fused, bucket_mb=None, **kw)
    trainer, buck, _, lb = _trainer_run(fused=fused, bucket_mb=bucket_mb, **kw)
    assert trainer._bucketed
    assert torch.equal(mono.theta, buck.theta) and torch.equal(lm, lb)
    if mono.mom is not None:
        assert torch.equal(mono.mom, buck.mom)


@pytest.mark.parametrize("fused", [False, True])
def test_trainer_bucketed_closed_loop_same_transitions(fused):
    kw = dict(topo_kw=dict(k_floor="one_peer", consensus_target=0.9), mix_every=2, steps=6)
    _, mono, mtopo, _ = _trainer_run("d_ada", fused=fused, bucket_mb=None, **kw)
    trainer, buck, btopo, _ = _trainer_run("d_ada", fused=fused, bucket_mb=0.01, **kw)
    assert mtopo.controller.transitions == btopo.controller.transitions != []
    for (sa, xa, ra), (sb, xb, rb) in zip(mtopo.controller.trace, btopo.controller.trace):
        assert (sa, ra) == (sb, rb) and xb == pytest.approx(xa, rel=1e-5, abs=1e-12)
    assert torch.equal(mono.theta, buck.theta)
    assert xi_from_folded_sq(trainer._fold.sq) == pytest.approx(
        float(consensus_distance_stacked(buck.theta)), rel=1e-5)


def test_trainer_bucket_validation():
    cfg = get_config("granite-8b-reduced")
    with pytest.raises(ValueError, match="SGD-family"):
        SPMDTrainer(cfg, make_topology("d_ring", 4), adamw(), bucket_mb=1.0, device="cpu")
    with pytest.raises(ValueError, match="decentralized"):
        SPMDTrainer(cfg, make_topology("c_complete", 4), sgd(), bucket_mb=1.0, device="cpu")
    with pytest.raises(ValueError, match="mix_order"):
        SPMDTrainer(cfg, make_topology("d_ring", 4, mix_order="pre"), sgd(), bucket_mb=1.0,
                    device="cpu")
