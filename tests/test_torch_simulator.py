"""Port parity: the port's ``DecentralizedSimulator`` against the reference's.

Both engines run from the same weights on the same numpy batches:

* the ``tests/test_dsgd_convergence.py`` problem (per-node noisy least
  squares, n = 16) on its six topologies, dense and shift mixing;
* the paper's LSTM (vocab 32, d 16, seq 8, n = 8, DBench norms on) under
  every engine option this slice ports: dense and shift, ``mix_every=2``,
  ``mix_rounds=2`` with and without ``hub_balance``, pre order,
  ``c_complete``, AdamW and LARS, and the mini ResNet;
* closed-loop Ada on the reference's acceptance problem
  (``tests/test_consensus.py``: n = 16, target 0.6, 48 steps).

Bars: parameters and losses within 5e-5 (the bar the port's trainer tests
hold), norms within rtol 1e-5, identical controller transitions.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dsgd as jdsgd  # noqa: E402
from repro.core.simulator import DecentralizedSimulator as JSim  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro_torch.core import dsgd as tdsgd  # noqa: E402
from repro_torch.core.dsgd import make_topology as tmake_topology  # noqa: E402
from repro_torch.core.simulator import DecentralizedSimulator as TSim  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

torch.set_num_threads(1)
# the optimizer modules (their packages export the function ``sgd`` by that name)
joptim = importlib.import_module("repro.optim.sgd")
toptim = importlib.import_module("repro_torch.optim.sgd")


def _run(sim_cls, topo_mod, loss_fn, params0, batches, lr, topo, topo_kw, opt, sim_kw,
         to_batch):
    """(flat final params {name: (n, ...)}, [losses (n,)], [norms], controller)."""
    topology = topo_mod.make_topology(topo, topo_kw.pop("n"), **topo_kw)
    extra = {"device": "cpu"} if sim_cls is TSim else {}
    sim = sim_cls(loss_fn, opt, topology, **sim_kw, **extra)
    state = sim.init(params0)
    losses, norms = [], []
    for t, b in enumerate(batches):
        state, loss, nrm = sim.train_step(state, to_batch(b), lr(t) if callable(lr) else lr,
                                          epoch=t // 5)
        losses.append(np.asarray(loss))
        norms.append(np.asarray(nrm))
    if sim_cls is TSim:
        params = {k: v.numpy() for k, v in state.params.items()}
    else:
        params = {k: v.numpy() for k, v in params_from_jax(jax.device_get(state.params)).items()}
    return params, losses, norms, topology.controller


def _both(loss, params0, batches, lr, topo, topo_kw, opt, sim_kw):
    jloss, tloss = loss
    jopt, topt = opt
    want = _run(JSim, jdsgd, jloss, params0,
                batches, lr, topo, dict(topo_kw), jopt(), dict(sim_kw),
                lambda b: {k: jnp.asarray(v) for k, v in b.items()})
    got = _run(TSim, tdsgd, tloss, params0,
               batches, lr, topo, dict(topo_kw), topt(), dict(sim_kw),
               lambda b: b)
    return got, want


def _check(got, want, *, norms=True):
    got_p, got_l, got_n, _ = got
    want_p, want_l, want_n, _ = want
    assert list(got_p) == list(want_p)
    maxdiff = max(float(np.abs(got_p[k] - want_p[k]).max()) for k in want_p)
    lossdiff = max(float(np.abs(a - b).max()) for a, b in zip(got_l, want_l))
    assert maxdiff < 5e-5, f"MAXDIFF={maxdiff:.3e}"
    assert lossdiff < 5e-5, f"LOSSDIFF={lossdiff:.3e}"
    if norms:
        for a, b in zip(got_n, want_n):
            np.testing.assert_allclose(a, b, rtol=1e-5)


# ---------------------------------------------------------------------------
# test_dsgd_convergence.py's problem and topologies
# ---------------------------------------------------------------------------

N, D = 16, 8
TARGET = np.arange(D, dtype=np.float32)


def _quad_jax(params, batch):
    return jnp.mean(jnp.sum((batch["obs"] - params["w"]) ** 2, -1))


def _quad_torch(params, batch):
    return torch.mean(torch.sum((batch["obs"] - params["w"]) ** 2, -1))


def _quad_batches(steps, seed=0):
    rng = np.random.default_rng(seed)
    return [{"obs": (TARGET + rng.standard_normal((N, 4, D))).astype(np.float32)}
            for _ in range(steps)]


@pytest.mark.parametrize("mixing", ["dense", "shift"])
@pytest.mark.parametrize(
    "topo", ["c_complete", "d_complete", "d_ring", "d_torus", "d_exponential", "d_ada"])
def test_convergence_topologies_match_reference(topo, mixing):
    got, want = _both(
        (_quad_jax, _quad_torch), {"w": np.zeros(D, np.float32)}, _quad_batches(12), 0.05,
        topo, {"n": N}, (lambda: joptim.sgd(momentum=0.9), lambda: toptim.sgd(momentum=0.9)),
        {"mixing": mixing, "collect_norms": True},
    )
    _check(got, want)


# ---------------------------------------------------------------------------
# The engine's options, on the paper's models
# ---------------------------------------------------------------------------

NL, VOCAB, DM, SEQ, BATCH, STEPS = 8, 32, 16, 8, 2, 6


@functools.lru_cache(maxsize=None)
def _lstm_init():
    return jax.device_get(jcommon.init_params(jpm.lstm_defs(vocab=VOCAB, d=DM),
                                              jax.random.PRNGKey(1)))


def _lstm_batches():
    src = SyntheticLM(vocab=VOCAB, seq_len=SEQ, seed=0)
    return [src.stacked(NL, t, BATCH) for t in range(STEPS)]


SGD = (lambda: joptim.sgd(momentum=0.9), lambda: toptim.sgd(momentum=0.9))
OPTION_CASES = {
    "d_ring-dense": ("d_ring", {}, SGD, {"mixing": "dense"}),
    "d_ring-shift": ("d_ring", {}, SGD, {"mixing": "shift"}),
    "d_exponential-mix_every2": ("d_exponential", {}, SGD, {"mix_every": 2}),
    "d_one_peer_exp-rounds2-dense": ("d_one_peer_exp", {}, SGD, {"mix_rounds": 2}),
    "d_one_peer_exp-rounds2-shift": ("d_one_peer_exp", {}, SGD,
                                     {"mix_rounds": 2, "mixing": "shift"}),
    "d_star-rounds2": ("d_star", {}, SGD, {"mix_rounds": 2, "mixing": "shift"}),
    "d_star-rounds3-hub": ("d_star", {}, SGD,
                           {"mix_rounds": 3, "hub_balance": True, "mixing": "shift"}),
    "d_ring-pre": ("d_ring", {"mix_order": "pre"}, SGD, {"mixing": "shift"}),
    "c_complete": ("c_complete", {}, SGD, {}),
    # Adam's lr: its step is ~lr per element whatever the gradient's scale
    "d_ring-adamw": ("d_ring", {}, (joptim.adamw, toptim.adamw), {"mixing": "shift"}, 0.01),
    "d_torus-lars": ("d_torus", {}, (joptim.lars, toptim.lars), {}),
    "d_ring-sgd-nesterov-wd": ("d_ring", {}, (
        lambda: joptim.sgd(0.9, weight_decay=1e-3, nesterov=True),
        lambda: toptim.sgd(0.9, weight_decay=1e-3, nesterov=True)), {"mixing": "shift"}),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_engine_options_match_reference(case):
    topo, topo_kw, opt, sim_kw, *lr = OPTION_CASES[case] + (0.5,)
    got, want = _both(
        (jpm.lstm_loss, tpm.lstm_loss), _lstm_init(), _lstm_batches(), lr[0],
        topo, {"n": NL, **topo_kw}, opt, {"collect_norms": True, **sim_kw},
    )
    _check(got, want)
    if topo != "c_complete":   # the replicas really diverged and mixed
        assert float(np.abs(got[1][-1] - got[1][-1].mean()).max()) > 0


def test_mini_resnet_matches_reference():
    params0 = jax.device_get(jcommon.init_params(jpm.mini_resnet_defs(channels=4, depth=1),
                                                 jax.random.PRNGKey(0)))
    batches = []
    for t in range(4):
        b = jax.device_get(jpm.synthetic_images(jax.random.PRNGKey(10 + t),
                                                batch=4 * 4, size=8))
        batches.append({"images": np.array(b["images"]).reshape(4, 4, 8, 8, 3),
                        "labels": np.array(b["labels"]).reshape(4, 4)})
    got, want = _both(
        (jpm.mini_resnet_loss, tpm.mini_resnet_loss), params0, batches, 0.1,
        "d_ring", {"n": 4}, SGD, {"collect_norms": True},
    )
    _check(got, want)


# ---------------------------------------------------------------------------
# Closed-loop Ada (tests/test_consensus.py's acceptance problem)
# ---------------------------------------------------------------------------

def _target_batches(steps=48):
    rng = np.random.default_rng(0)
    return [{"t": rng.normal(size=(16, 8)).astype(np.float32)} for _ in range(steps)]


@pytest.mark.parametrize("mixing", ["stacked", "dense"])
def test_closed_loop_ada_matches_reference(mixing):
    got, want = _both(
        (lambda p, b: jnp.mean((p["w"] - b["t"]) ** 2),
         lambda p, b: torch.mean((p["w"] - b["t"]) ** 2)),
        {"w": np.zeros(8, np.float32)}, _target_batches(), lambda t: 0.4 * (0.8 ** t),
        "d_ada", {"n": 16, "k0": 4, "k_floor": "one_peer", "consensus_target": 0.6},
        SGD, {"mixing": mixing},
    )
    _check(got, want, norms=False)
    tctl, jctl = got[3], want[3]
    assert tctl.transitions == jctl.transitions
    assert tctl.handoff_step is not None and tctl.handoff_step == jctl.handoff_step
    assert [(s, r) for s, _, r in tctl.trace] == [(s, r) for s, _, r in jctl.trace]
    # Ξ is an RMS of parameter differences: late in the run it is ~1e-4 of
    # the parameters' scale, so it carries their 5e-5 bar, not a relative one
    np.testing.assert_allclose([x for _, x, _ in tctl.trace],
                               [x for _, x, _ in jctl.trace], rtol=1e-5, atol=5e-5)
    assert tctl.events == jctl.events


def test_closed_loop_probe_cadence():
    topo = tmake_topology("d_ada", 16, k0=3, k_floor="one_peer", consensus_target=0.6,
                          consensus_probe_every=4)
    sim = TSim(lambda p, b: torch.mean((p["w"] - b["t"]) ** 2), toptim.sgd(0.9), topo,
               device="cpu")
    state = sim.init({"w": np.zeros(4, np.float32)})
    rng = np.random.default_rng(1)
    for _ in range(9):
        state, _, _ = sim.train_step(state, {"t": rng.normal(size=(16, 4)).astype(np.float32)},
                                     0.1)
    assert [s for s, _, _ in topo.controller.trace] == [0, 4, 8]


# ---------------------------------------------------------------------------
# Engine contract
# ---------------------------------------------------------------------------

def test_node_loop_equals_vmap():
    topo = tmake_topology("d_ring", NL)
    out = []
    for node_loop in (False, True):
        sim = TSim(tpm.lstm_loss, toptim.sgd(0.9), topo, collect_norms=True,
                   node_loop=node_loop, device="cpu")
        state = sim.init(_lstm_init())
        for b in _lstm_batches()[:3]:
            state, loss, norms = sim.train_step(state, b, 0.5)
        out.append((state.theta.clone(), loss, norms))
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[0][1].numpy(), out[1][1].numpy(), rtol=1e-6)


def test_mean_params_and_run_history():
    topo = tmake_topology("d_ring", NL)
    sim = TSim(tpm.lstm_loss, toptim.sgd(0.9), topo, collect_norms=True, device="cpu")
    from repro_torch.core.dbench import DBenchRecorder

    rec = DBenchRecorder(impl="d_ring", n_nodes=NL)
    state, hist = sim.run(_lstm_init(), iter(_lstm_batches()), n_steps=STEPS,
                          lr_schedule=lambda t: 0.5, recorder=rec,
                          eval_fn=lambda p: float(p["head"].abs().sum()), eval_every=3)
    assert hist["step"] == list(range(STEPS)) and len(hist["loss"]) == STEPS
    assert hist["eval_step"] == [3, 6]
    assert rec.metric_series("gini").shape == (STEPS, 5)
    mean = state.mean_params()
    np.testing.assert_allclose(mean["wx"].numpy(), state.params["wx"].mean(0).numpy(),
                               rtol=0, atol=1e-7)
    assert state.step == STEPS


def test_has_rng_runs_the_node_loop_with_the_generator():
    def noisy(p, b, gen):
        return torch.mean((p["w"] - b["t"]) ** 2) + 0 * torch.rand((), generator=gen)

    topo = tmake_topology("d_ring", 4)
    sim = TSim(noisy, toptim.sgd(0.9), topo, has_rng=True, device="cpu")
    assert sim.node_loop
    state = sim.init({"w": np.zeros(3, np.float32)})
    state, loss, _ = sim.train_step(state, {"t": np.ones((4, 3), np.float32)}, 0.1,
                                    rng=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss).all()


@pytest.mark.parametrize("kw,step", [
    ({"shard_nodes": True}, None),        # one device: ported, accepted
    ({"debug_no_retrace": True}, None),   # the rebuild guard is ported: accepted
    ({"mixing": "ring"}, "mixing must be"),
])
def test_later_slices_raise(kw, step):
    make = lambda: TSim(tpm.lstm_loss, toptim.sgd(0.9), tmake_topology("d_ring", 4),
                        device="cpu", **kw)
    if step is None:
        sim = make()
        assert all(getattr(sim, k) == v for k, v in kw.items())
        return
    with pytest.raises(ValueError, match=step):
        make()


# ---------------------------------------------------------------------------
# Virtual-node sharding (``tests/test_elastic.py``'s cases, held against the
# reference): on one device the rows stay where they are
# ---------------------------------------------------------------------------

def _shard_run(n, rate, seed, steps, batch_rows, shard, data_seed):
    """The port's and the reference's simulator on a quadratic loss under
    dropout: (port θ, port losses, reference θ, reference losses)."""
    from repro.core.faults import make_fault_model as jfault
    from repro_torch.core.faults import make_fault_model as tfault

    jsim = JSim(lambda p, b: jnp.mean((b - p["w"]) ** 2), joptim.sgd(0.1),
                jdsgd.make_topology("d_one_peer_exp", n,
                                    fault_model=jfault("dropout", n, rate=rate, seed=seed)),
                mixing="shift", shard_nodes=shard)
    tsim = TSim(lambda p, b: torch.mean((b["b"] - p["w"]) ** 2), toptim.sgd(0.1),
                tmake_topology("d_one_peer_exp", n,
                               fault_model=tfault("dropout", n, rate=rate, seed=seed)),
                mixing="shift", shard_nodes=shard, device="cpu")
    jstate = jsim.init({"w": jnp.zeros((4,), jnp.float32)})
    tstate = tsim.init({"w": np.zeros((4,), np.float32)})
    rng = np.random.default_rng(data_seed)
    for _ in range(steps):
        b = rng.normal(size=(n, batch_rows, 4)).astype(np.float32)
        jstate, jloss, _ = jsim.train_step(jstate, jnp.asarray(b), 0.05)
        tstate, tloss, _ = tsim.train_step(tstate, {"b": torch.from_numpy(b)}, 0.05)
    return (tstate.params["w"].numpy().copy(), tloss.numpy().copy(),
            np.asarray(jstate.params["w"]), np.asarray(jloss))


def test_shard_nodes_is_numeric_noop():
    """n 8 under dropout: bit for bit the unsharded run, both within 5e-5
    of the reference's (sharded and not)."""
    plain = _shard_run(8, 0.3, 3, 6, 2, False, 2)
    sharded = _shard_run(8, 0.3, 3, 6, 2, True, 2)
    np.testing.assert_array_equal(plain[0], sharded[0])
    np.testing.assert_array_equal(plain[1], sharded[1])
    np.testing.assert_array_equal(plain[2], sharded[2])
    np.testing.assert_allclose(sharded[0], sharded[2], rtol=0, atol=5e-5)
    np.testing.assert_allclose(sharded[1], sharded[3], rtol=0, atol=5e-5)


def test_shard_nodes_runs_large_n():
    """n 512 one-peer steps under dropout run through the sharded path and
    agree with the reference's."""
    theta, loss, jtheta, jloss = _shard_run(512, 0.1, 0, 3, 1, True, 0)
    assert loss.shape == (512,)
    assert np.isfinite(theta).all()
    np.testing.assert_allclose(theta, jtheta, rtol=0, atol=5e-5)
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=5e-5)


def test_shard_nodes_resolves_a_split_over_four_cards(monkeypatch):
    """With 4 cards the split resolves to 4 blocks, where it used to raise;
    the state builds as 4 row blocks (``tests/test_torch_node_split.py``
    runs the split)."""
    from repro_torch.core import node_split
    from repro_torch.core.node_split import NodeBlocks

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    sim = TSim(tpm.lstm_loss, toptim.sgd(0.9), tmake_topology("d_ring", 8),
               device=torch.device("cuda", 0), shard_nodes=True)
    assert sim.devices == [torch.device("cuda", i) for i in range(4)]
    assert len(sim._split(10)) == 2 and sim._split(7) == [torch.device("cuda", 0)]
    # the blocks build, each of the resolved devices' count on the CPU
    real = node_split.split_devices
    monkeypatch.setattr(node_split, "split_devices", lambda n, dev: [torch.device("cpu")] * len(
        real(n, torch.device("cuda", 0))))
    cpu = TSim(tpm.lstm_loss, toptim.sgd(0.9), tmake_topology("d_ring", 8),
               device="cpu", shard_nodes=True)
    state = cpu.init({"w": np.zeros(3, np.float32)})
    assert isinstance(state.theta, NodeBlocks) and state.theta.starts == (0, 2, 4, 6, 8)
    assert torch.equal(state.theta.to_full(), torch.zeros(8, 3))
