"""Port parity: faults and elastic membership on a model axis — the
tensor-parallel ranks engine on a (2 data × 2 model) world of 4 gloo ranks
on the CPU, G = 2 nodes of 2 model ranks each.

Every case starts from the reference's ``init_model(cfg, key, tp_size=2)``
leaves of granite-8b-reduced and trains 4 steps (float32, seq 16, per-node
batch 2, ``sgd(0.9)``, lr 0.05, norms on) on d_ring under a fault model:

* ``crash`` with ``down_steps`` 1 (seed 2: node 1 is down at step 1 and
  rejoins at step 2 with its neighbour's average), fused (K2's twin with
  the node's fault row on each shard row);
* ``dropout`` (node 0 out at steps 0 and 3, node 1 at step 2), interpreter;
* ``link`` failure (the ring's link down at step 0), fused;
* ``join`` through ``--spare-ranks`` 1 (node 1 a spare node of 2 model ranks
  until it activates at step 2), fused;
* closed-loop d_ada under the crash: the controller's probes read the
  masked Ξ on shard rows (each rank's partial sum over the leaves it counts,
  summed over the node's model group).

Each is held against the reference's dense simulator under the same fault
model (parameters and losses within 5e-5, norms within rtol 1e-5) and
against the port's stacked engine on the same (2 × 2) mesh in one process
(within 5e-5: the model group's all-reduces reorder the forward's sums,
so the two engines are not bit for bit as at tp 1).  Every leaf the model
axis leaves whole is the same bits on both model ranks of a node after
every run.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_g1_worker  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.dsgd import make_topology as jmake_topology  # noqa: E402
from repro.core.simulator import DecentralizedSimulator  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim.sgd import sgd as jsgd  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

G, TP, STEPS, SEQ, BATCH, LR = 2, 2, 4, 16, 2, 0.05
MESH = ((G, TP), ("data", "model"))
ARCH = "granite-8b"
# name -> (fault kind, its keyword arguments, fused)
CRASH = (("rate", 0.5), ("seed", 2), ("down_steps", 1))
CLOSED = ("d_ada", (("k_floor", "one_peer"), ("consensus_target", 0.9)))
# name -> (fault kind, its keyword arguments, fused, topology)
FAULTS = {
    "crash": ("crash", CRASH, True, "d_ring"),
    "dropout": ("dropout", (("rate", 0.4), ("seed", 1)), False, "d_ring"),
    "link": ("link", (("rate", 0.5), ("seed", 1)), True, "d_ring"),
    "spare-join": ("join", (("seed", 0), ("join_steps", (2,)), ("spare_ranks", 1)), True,
                   "d_ring"),
    "closed-loop-crash": ("crash", CRASH, True, CLOSED),
}
CASES = {name: (ARCH, (), (kind, kw), topology, fused)
         for name, (kind, kw, fused, topology) in FAULTS.items()}


@functools.lru_cache(maxsize=None)
def _init():
    cfg = dataclasses.replace(jget_config(ARCH + "-reduced"), dtype=jnp.float32, remat=False)
    tree = jax.device_get(jax.jit(lambda k: jtfm.init_model(cfg, k, tp_size=TP))(
        jax.random.PRNGKey(7)))
    return cfg, tree, {k: v.float().numpy() for k, v in params_from_jax(tree).items()}


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else {f"{prefix}{k}": np.asarray(v)})
    return out


@functools.lru_cache(maxsize=None)
def _oracle(name):
    """The reference's dense simulator under the case's fault model (None:
    none):
    (params {name: (G, ...)}, losses (STEPS, G), norms (STEPS, G, L), the
    controller's transitions)."""
    cfg, tree, _ = _init()
    fm, topology = None, "d_ring"
    if name is not None:
        kind, kw, _, topology = FAULTS[name]
        fm = jfaults.make_fault_model(kind, G, **dict(kw))
    tname, tkw = (topology, ()) if isinstance(topology, str) else topology
    topo = jmake_topology(tname, G, fault_model=fm, **dict(tkw))
    sim = DecentralizedSimulator(lambda p, b: jtfm.loss_fn(p, cfg, b), jsgd(0.9), topo,
                                 mixing="dense", collect_norms=True)
    state = sim.init(jax.tree.map(jnp.asarray, tree))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    for t in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in src.stacked(G, t, BATCH).items()}
        state, loss, nrm = sim.train_step(state, batch, LR, epoch=0)
        losses.append(np.asarray(loss))
        norms.append(np.asarray(nrm))
    ctl = topo.controller
    return (_flat(jax.device_get(state.params)), np.stack(losses), np.stack(norms),
            None if ctl is None else list(ctl.transitions))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Per case, the results of ranks 0..3 (rank i·2 + j: shard j of node i)."""
    params = {name: _init()[2] for name in CASES}
    results = spawn_world(
        _torch_g1_worker.world_cases, G * TP,
        (CASES, params, STEPS, SEQ, BATCH, LR, *MESH), timeout=300, device="cpu",
        workdir=tmp_path_factory.mktemp("world"))
    return {name: [r[name] for r in results] for name in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_fault_world_matches_the_dense_oracle(world, case):
    per_rank = world[case]
    assert all(r["engine"] == ("ranks", G, 1, TP) for r in per_rank)
    want_p, want_l, want_n, want_tr = _oracle(case)
    assert all(r["transitions"] == want_tr for r in per_rank)
    losses = np.stack([per_rank[i * TP]["losses"][:, 0] for i in range(G)], axis=1)
    np.testing.assert_allclose(losses, want_l, rtol=0, atol=5e-5)
    norms = np.stack([per_rank[i * TP]["norms"][:, 0] for i in range(G)], axis=1)
    np.testing.assert_allclose(norms, want_n, rtol=1e-5, atol=1e-30)
    for k, w in want_p.items():
        got = np.concatenate([per_rank[i * TP]["full"][k] for i in range(G)])
        assert float(np.abs(got - w).max()) < 5e-5, k
    # the faults did something: the run is not the fault-free one
    free = _oracle(None)[0]
    assert max(float(np.abs(w - free[k]).max()) for k, w in want_p.items()) > 1e-3
    for i in range(G):
        a, b = per_rank[i * TP], per_rank[i * TP + 1]
        assert np.array_equal(a["losses"], b["losses"])
        for k, (model_whole, _) in a["whole"].items():
            if model_whole:
                assert np.array_equal(a["local"][k], b["local"][k]), k
    assert all(set(r["launches"].values()) <= {0} for r in per_rank)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_fault_world_matches_the_stacked_engine(world, case):
    per_rank = world[case]
    arch, replace, fault, topology, fused = CASES[case]
    st = _torch_g1_worker.stacked(arch, replace, *MESH, _init()[2], STEPS, SEQ, BATCH, LR,
                                  fault=fault, topology=topology, fused=fused)
    assert st["engine"] == ("stacked", G, 1, TP)
    for i in range(G):
        r = per_rank[i * TP]
        np.testing.assert_allclose(r["losses"][:, 0], st["losses"][:, i], rtol=0, atol=5e-5)
        np.testing.assert_allclose(r["norms"][:, 0], st["norms"][:, i], rtol=1e-5, atol=1e-30)
        for k, v in r["full"].items():
            assert float(np.abs(v[0] - st["full"][k][i]).max()) < 5e-5, k
