"""Port parity: the port's trainer against the reference's dense oracle.

The port's ``SPMDTrainer`` on the CPU (granite-8b-reduced in float32, G = 4,
seq 16, per-node batch 2, ``sgd(0.9)``, DBench norms on) runs 4 steps from
the reference's weights, carried across with ``params_from_jax``, on the
same ``SyntheticLM`` batches as ``repro.core.simulator.DecentralizedSimulator``
with ``mixing="dense"`` — the oracle of ``tests/spmd_equivalence_script.py``.
Bounds: parameters and losses within 5e-5 (the reference's own bar for its
trainer), norms within rtol 1e-5.
"""
import dataclasses
import functools

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
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.optim.sgd import sgd as tsgd  # noqa: E402

torch.set_num_threads(1)

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


@functools.lru_cache(maxsize=None)
def _oracle(topology, mix_order="post"):
    """(final params {path: (G, ...)}, [losses (G,)], [norms (G, L)])."""
    cfg, params = _init()
    topo = jmake_topology(topology, G, mix_order=mix_order)
    sim = DecentralizedSimulator(
        lambda p, b: jtfm.loss_fn(p, cfg, b), jsgd(momentum=0.9), topo,
        mixing="dense", collect_norms=True,
    )
    state = sim.init(jax.tree.map(jnp.asarray, params))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    for t in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in src.stacked(G, t, BATCH).items()}
        state, loss, nrm = sim.train_step(state, batch, LR, epoch=0)
        losses.append(np.asarray(loss))
        norms.append(np.asarray(nrm))
    return _flat_np(jax.device_get(state.params)), losses, norms


def _port(topology, fused, mix_order="post"):
    cfg, params = _init()
    tcfg = tget_config("granite-8b-reduced")
    trainer = SPMDTrainer(
        tcfg, tmake_topology(topology, G, mix_order=mix_order), tsgd(momentum=0.9),
        collect_norms=True, fused_apply=fused, device="cpu",
    )
    state = trainer.init_state(params=params_from_jax(params))
    src = SyntheticLM(vocab=tcfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    for t in range(STEPS):
        state, loss, nrm = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
        losses.append(loss.numpy())
        norms.append(nrm.numpy())
    final = {k: v.numpy() for k, v in trainer.stacked_params(state).items()}
    return final, losses, norms


def _compare(topology, fused, mix_order="post"):
    want_p, want_l, want_n = _oracle(topology, mix_order)
    got_p, got_l, got_n = _port(topology, fused, mix_order)
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
    (["--mix-rounds", "2"], "step 8"),
    (["--bucket-mb", "4"], "step 10"),
    (["--fault-model", "crash"], "step 10"),
    (["--ckpt-dir", "x"], "step 10"),
    (["--telemetry", "t.jsonl"], "step 11"),
    (["--consensus-target", "0.5"], "step 7"),
    (["--optimizer", "adamw"], "step 3"),
    (["--mesh", "2,2"], "step 13"),
])
def test_main_rejects_later_slices(argv, step):
    with pytest.raises(SystemExit, match=step):
        main(["--reduced", "--steps", "1"] + argv, device="cpu")


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
