"""Port parity: the port's trainer against the reference's dense oracle.

The port's ``SPMDTrainer`` on the CPU (granite-8b-reduced in float32, G = 4,
seq 16, per-node batch 2, ``sgd(0.9)``, DBench norms on) runs 4 steps from
the reference's weights, carried across with ``params_from_jax``, on the
same ``SyntheticLM`` batches as ``repro.core.simulator.DecentralizedSimulator``
with ``mixing="dense"`` — the oracle of ``tests/spmd_equivalence_script.py``.
Bounds: parameters and losses within 5e-5 (the reference's own bar for its
trainer), norms within rtol 1e-5.  The same holds under ``mix_rounds``
(fused one-peer cycles, hub-balanced stars), closed-loop Ada (identical
controller transitions) and the AdamW and LARS optimizers; the fused
multi-round path (K1's twin on round 1, the interpreter after it) equals
the unfused one within 1e-6.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.dsgd import make_topology as jmake_topology  # noqa: E402
from repro.core.simulator import DecentralizedSimulator  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim.sgd import sgd as jsgd  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.dsgd import make_topology as tmake_topology  # noqa: E402
from repro_torch.launch.train import SPMDTrainer, main  # noqa: E402
from repro_torch.models.transformer import model_defs as tmodel_defs  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.optim.sgd import sgd as tsgd  # noqa: E402

torch.set_num_threads(1)
# the optimizer modules (their packages export the function ``sgd`` by that name)
jopt = importlib.import_module("repro.optim.sgd")
topt = importlib.import_module("repro_torch.optim.sgd")

G, STEPS, SEQ, BATCH, LR = 4, 4, 16, 2, 0.05


def _flat_np(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _init():
    cfg = dataclasses.replace(
        jget_config("granite-8b-reduced"), dtype=jnp.float32, remat=False
    )
    params = jax.jit(lambda k: jtfm.init_model(cfg, k, tp_size=1))(jax.random.PRNGKey(42))
    return cfg, jax.device_get(params)


# name -> (topology, make_topology kwargs, engine kwargs, (optimizer, kwargs), lr):
# the cases beyond momentum-SGD on one gossip round; every engine kwarg is
# one that both the reference's simulator and the port's trainer take
EXTRA = {
    "d_one_peer_exp-rounds2": ("d_one_peer_exp", {}, {"mix_rounds": 2}, ("sgd", {}), LR),
    "d_star-rounds3-hub": ("d_star", {}, {"mix_rounds": 3, "hub_balance": True},
                           ("sgd", {}), LR),
    "d_ring-rounds2-pre": ("d_ring", {"mix_order": "pre"}, {"mix_rounds": 2},
                           ("sgd", {}), LR),
    # closed loop: the ladder is (2, one_peer) at G = 4; gossiping every
    # other step, Ξ falls after the first mix and the handoff fires at step 2
    "d_ada-closed": ("d_ada", {"k_floor": "one_peer", "consensus_target": 0.9},
                     {"mix_every": 2}, ("sgd", {}), LR),
    # AdamW scales every gradient to a step of up to lr, rounding noise too
    # (wk's softmax-invariant directions): both engines' parameters part by
    # ~0.11·lr (2.1e-4 at lr 2e-3), so the case runs at a transformer's
    # Adam lr of 1e-4
    "d_ring-adamw": ("d_ring", {}, {}, ("adamw", {}), 1e-4),
    "d_exponential-lars": ("d_exponential", {}, {}, ("lars", {}), 0.5),
}


def _spec(topology, mix_order="post"):
    return (topology, {"mix_order": mix_order}, {}, ("sgd", {}), LR)


def _freeze(spec):
    """A hashable spec: dicts as sorted item tuples."""
    topology, topo_kw, engine_kw, (opt, opt_kw), lr = spec
    items = lambda d: tuple(sorted(dict(d).items()))
    return topology, items(topo_kw), items(engine_kw), (opt, items(opt_kw)), lr


@functools.lru_cache(maxsize=None)
def _oracle_case(spec):
    """(final params {path: (G, ...)}, [losses (G,)], [norms (G, L)],
    controller transitions or None) of the reference's dense simulator."""
    topology, topo_kw, engine_kw, (opt, opt_kw), lr = spec
    cfg, params = _init()
    topo = jmake_topology(topology, G, **dict(topo_kw))
    sim = DecentralizedSimulator(
        lambda p, b: jtfm.loss_fn(p, cfg, b), jopt.get_optimizer(opt, **dict(opt_kw)), topo,
        mixing="dense", collect_norms=True, **dict(engine_kw),
    )
    state = sim.init(jax.tree.map(jnp.asarray, params))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    for t in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in src.stacked(G, t, BATCH).items()}
        state, loss, nrm = sim.train_step(state, batch, lr, epoch=0)
        losses.append(np.asarray(loss))
        norms.append(np.asarray(nrm))
    ctl = topo.controller
    return (_flat_np(jax.device_get(state.params)), losses, norms,
            None if ctl is None else list(ctl.transitions))


def _oracle(topology, mix_order="post"):
    """(final params {path: (G, ...)}, [losses (G,)], [norms (G, L)])."""
    return _oracle_case(_freeze(_spec(topology, mix_order)))[:3]


def _port_case(spec, fused):
    """The port's trainer on the CPU: (params, losses, norms, transitions)."""
    topology, topo_kw, engine_kw, (opt, opt_kw), lr = spec
    _, params = _init()
    tcfg = tget_config("granite-8b-reduced")
    topo = tmake_topology(topology, G, **dict(topo_kw))
    trainer = SPMDTrainer(
        tcfg, topo, topt.get_optimizer(opt, **dict(opt_kw)),
        collect_norms=True, fused_apply=fused, device="cpu", **dict(engine_kw),
    )
    state = trainer.init_state(params=params_from_jax(params))
    src = SyntheticLM(vocab=tcfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    for t in range(STEPS):
        state, loss, nrm = trainer.train_step(state, src.stacked(G, t, BATCH), lr)
        losses.append(loss.numpy())
        norms.append(nrm.numpy())
    final = {k: v.numpy() for k, v in trainer.stacked_params(state).items()}
    ctl = topo.controller
    return final, losses, norms, None if ctl is None else list(ctl.transitions)


def _port(topology, fused, mix_order="post"):
    return _port_case(_spec(topology, mix_order), fused)[:3]


def _compare(topology, fused, mix_order="post"):
    _compare_case(_spec(topology, mix_order), fused)


def _compare_case(spec, fused):
    want_p, want_l, want_n, want_tr = _oracle_case(_freeze(spec))
    got_p, got_l, got_n, got_tr = _port_case(spec, fused)
    assert got_tr == want_tr
    if "consensus_target" in dict(spec[1]):
        assert got_tr, "the closed loop never moved"
    assert list(got_p) == list(want_p)
    maxdiff = max(float(np.abs(got_p[k] - want_p[k]).max()) for k in want_p)
    lossdiff = max(float(np.abs(a - b).max()) for a, b in zip(got_l, want_l))
    assert maxdiff < 5e-5, f"MAXDIFF={maxdiff:.3e}"
    assert lossdiff < 5e-5, f"LOSSDIFF={lossdiff:.3e}"
    for a, b in zip(got_n, want_n):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    # the replicas really diverged and mixed: not a trivially equal run
    assert float(np.abs(got_l[-1] - got_l[-1].mean()).max()) > 0


@pytest.mark.parametrize("fused", [False, True], ids=["interpreter", "fused"])
@pytest.mark.parametrize("topology", ["d_ring", "d_exponential"])
def test_trainer_matches_dense_oracle(topology, fused):
    _compare(topology, fused)


def test_trainer_centralized_takes_interpreter():
    """c_complete all-reduces gradients; fused_apply leaves it on the
    interpreter (no mixing program)."""
    _compare("c_complete", True)


def test_trainer_pre_order_matches_dense_oracle():
    _compare("d_ring", True, mix_order="pre")


def test_main_runs_end_to_end(capsys):
    out = main(["--reduced", "--steps", "3", "--mesh", "4,1"], device="cpu")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    printed = capsys.readouterr().out
    assert "apply interpreter" in printed and "3 steps in" in printed


def test_main_fused_apply_launches_through_the_wrapper(capsys):
    out = main(["--reduced", "--steps", "2", "--mesh", "4,1", "--topology", "d_ring",
                "--fused-apply", "--seq", "16"], device="cpu")
    assert all(np.isfinite(out["losses"]))
    assert "apply fused kernel K1" in capsys.readouterr().out


@pytest.mark.parametrize("argv,step", [
    # the checkpoint flags (item 4) run since they were ported: see
    # tests/test_torch_resume.py; so does a model axis (item 8): on one
    # device --mesh 2,2 runs the stacked engine at the reference's padded
    # shapes, under 4 ranks the tensor-parallel ranks engine
    # (tests/test_torch_tp_ranks.py); what item 8 left raises there
    pytest.param(["--mesh", "2,2"], "item 8", id="argv3-item 8"),
])
def test_main_rejects_later_slices(argv, step):
    out = main(["--reduced", "--steps", "2", "--arch", "qwen2.5-14b",
                "--seq", "16"] + argv, device="cpu")
    trainer = out["trainer"]
    assert trainer.engine == "stacked" and trainer.tp_size == 2 and trainer.tp is None
    assert {k: (d.shape, d.spec) for k, d in trainer.defs.items()} == {
        k: (d.shape, d.spec) for k, d in tmodel_defs(trainer.cfg, 2).items()}
    cfg = tget_config("qwen2.5-14b-reduced")
    h_pad, kv_pad = jtfm.attn_dims(jget_config("qwen2.5-14b-reduced"), 2)
    assert trainer.defs["blocks.wq"].shape == (cfg.n_layers, cfg.d_model, h_pad, cfg.head_dim)
    assert trainer.defs["blocks.wk"].shape[2] == kv_pad
    assert all(np.isfinite(out["losses"]))


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without a card and without an explicit CPU request nothing runs."""
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SPMDTrainer(tget_config("granite-8b-reduced"), tmake_topology("d_ring", 4),
                    tsgd(0.9))
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("case", list(EXTRA))
def test_trainer_options_match_dense_oracle(case):
    """Multi-round (fused and hub-balanced) programs, closed-loop Ada and
    the other optimizers, against the reference's simulator."""
    _compare_case(EXTRA[case], fused=False)


@pytest.mark.parametrize("case", ["d_one_peer_exp-rounds2", "d_star-rounds3-hub",
                                  "d_ada-closed"])
def test_fused_multi_round_equals_unfused(case):
    """K1's twin runs the update and round 1, the interpreter the later
    rounds in column chunks: the unfused step's numbers within 1e-6, and
    the same transitions."""
    spec = EXTRA[case]
    want_p, want_l, _, want_tr = _port_case(spec, False)
    got_p, got_l, _, got_tr = _port_case(spec, True)
    assert got_tr == want_tr
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=1e-6, err_msg=k)
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_fused_split_follows_the_reference_rules():
    from repro_torch.core.schedule import FusedProgram

    tcfg = tget_config("granite-8b-reduced")

    def split(topology, rounds, fused=True, **kw):
        t = SPMDTrainer(tcfg, tmake_topology(topology, G, **kw), tsgd(0.9),
                        mix_rounds=rounds, fused_apply=fused, device="cpu")
        return t._fused_split(t._program_at(0, 0)), t._program_at(0, 0)

    (first, rest), prog = split("d_one_peer_exp", 2)
    assert isinstance(prog, FusedProgram)
    assert first is prog.stages[0] and rest == prog.stages[1:]
    assert split("d_ring", 2, mix_order="pre")[0] is None       # descent after ALL rounds
    assert split("d_ring", 1, mix_order="pre")[0] is not None   # one round: the kernel's pre
    assert split("d_complete", 2)[0] is None                    # AllReduce first round
    assert split("d_ring", 2, fused=False)[0] is None
    (first, rest), _ = split("d_star", 3)
    assert first.permute_tables() is not None and len(rest) == 2


def test_mix_in_place_in_chunks_equals_one_pass(monkeypatch):
    from repro_torch.kernels import gossip_update

    prog = tmake_topology("d_one_peer_exp", G).fused_program_at(step=0, rounds=2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((G, 1000)).astype(np.float32))
    want = prog.apply_stacked(x)
    monkeypatch.setattr(gossip_update, "WIRE_CHUNK", 64)
    got = x.clone()
    gossip_update.mix_in_place(prog.stages, got, lambda st, v: st.apply_stacked(v))
    assert torch.equal(got, want)


def test_precompile_enumerates_every_rung_and_round():
    tcfg = tget_config("granite-8b-reduced")
    topo = tmake_topology("d_ada", 8, k0=4, k_floor="one_peer", consensus_target=0.5)
    t = SPMDTrainer(tcfg, topo, tsgd(0.9), mix_rounds=2, device="cpu")
    progs = t.precompile_programs()
    assert topo.controller.rung == 0
    assert all(p.name.startswith("fuse[") for p in progs)
    # the lattice rungs k=4 and k=2, and the one-peer cycle (period 3 at
    # n = 8) taken two schedule steps per round
    assert len(progs) == 2 + 3


def test_main_runs_the_new_flags(capsys):
    out = main(["--reduced", "--steps", "3", "--mesh", "4,1", "--topology", "d_ada",
                "--k-floor", "one_peer", "--consensus-target", "0.9",
                "--consensus-every", "1", "--mix-rounds", "2", "--fused-apply",
                "--seq", "16"], device="cpu")
    assert all(np.isfinite(out["losses"]))
    printed = capsys.readouterr().out
    assert "closed-loop Ada" in printed and "| rounds 2 |" in printed
    assert "apply fused kernel K1" in printed and "consensus controller:" in printed
    out = main(["--reduced", "--steps", "2", "--mesh", "4,1", "--topology", "d_star",
                "--mix-rounds", "3", "--hub-balance", "--optimizer", "lars",
                "--seq", "16"], device="cpu")
    assert all(np.isfinite(out["losses"]))
    assert "lars(" in capsys.readouterr().out
    with pytest.raises(ValueError, match="momentum-SGD only"):
        main(["--reduced", "--steps", "1", "--optimizer", "adamw", "--fused-apply"],
             device="cpu")
