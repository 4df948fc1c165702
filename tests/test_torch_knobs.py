"""Port parity: the trainer's knobs (``accum_steps``, ``loss_fn=``, the
model's ``remat``/``remat_policy``), the data iterator and the examples.

* ``accum_steps = 2`` and a custom ``loss_fn`` against the reference's
  ``SPMDTrainer(accum_steps=2)`` and ``SPMDTrainer(loss_fn=...)`` on 4 host
  devices (a subprocess: the test process has one), 3 steps of
  granite-8b-reduced in float32 from the same weights and batches:
  parameters and losses within 5e-5, in the port's fused and unfused
  steps; the microbatch mean of the loss and gradients equal to the
  reference's ``_grads_of`` within 5e-5 on one node;
* remat on (``"full"`` and ``"dots"``) equals remat off bit for bit in the
  trainer (fused and unfused) and the simulator, and the port's
  gradients with remat within 5e-5 of the reference's with its remat;
* ``node_batch_iterator`` equals the reference's batch for batch;
* both examples run a few steps on the CPU, and the quickstart's loss
  falls.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data import node_batch_iterator as jnode_batch_iterator  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.dsgd import make_topology  # noqa: E402
from repro_torch.core.flat import FlatLayout, node_grads_into  # noqa: E402
from repro_torch.core.simulator import DecentralizedSimulator  # noqa: E402
from repro_torch.data import SyntheticLM, node_batch_iterator  # noqa: E402
from repro_torch.examples import dbench_whitebox, quickstart  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402
from test_torch_train import BATCH, G, LR, SEQ, _flat_np, _init  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KNOB_STEPS = 3
REG = 1e-3   # the custom loss: CE plus REG · |final_norm.g|²

# the reference's trainer on 4 host devices: d_ring, sgd(0.9), from the
# weights in params.npz; writes each case's final stacked params and losses
REF_SCRIPT = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.dsgd import make_topology
from repro.data import SyntheticLM
from repro.launch.mesh import make_mesh
from repro.launch.train import SPMDTrainer, TrainState
from repro.models import transformer as tfm
from repro.optim.sgd import sgd

out_dir, steps, seq, batch, lr, reg = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
    int(sys.argv[4]), float(sys.argv[5]), float(sys.argv[6])
cfg = dataclasses.replace(get_config("granite-8b-reduced"), dtype=jnp.float32, remat=False)
flat = dict(np.load(out_dir + "/params.npz"))
params = {}
for path, v in flat.items():
    node = params
    *parents, leaf = path.split(".")
    for k in parents:
        node = node.setdefault(k, {})
    node[leaf] = jnp.asarray(v)
mesh = make_mesh((4, 1), ("data", "model"))
custom = lambda p, b: tfm.loss_fn(p, cfg, b) + reg * jnp.sum(p["final_norm"]["g"] ** 2)
for name, kw in (("accum2", {"accum_steps": 2}), ("loss_fn", {"loss_fn": custom})):
    opt = sgd(momentum=0.9)
    tr = SPMDTrainer(cfg, mesh, make_topology("d_ring", 4), opt, **kw)
    stack = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x[None], (4,) + x.shape), t)
    state = TrainState(jax.device_put(stack(params), tr.param_shardings),
                       jax.device_put(stack(opt.init(params)), tr.opt_shardings), 0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0)
    losses = []
    for t in range(steps):
        b = {k: jnp.asarray(v) for k, v in src.stacked(4, t, batch).items()}
        state, loss, _ = tr.train_step(state, b, lr)
        losses.append(np.asarray(loss))
    res = {"losses": np.stack(losses)}
    def walk(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], prefix + k + ".")
            else:
                res["p." + prefix + k] = np.asarray(tree[k])
    walk(jax.device_get(state.params))
    np.savez(out_dir + "/" + name + ".npz", **res)
print("REF_OK")
"""


@functools.lru_cache(maxsize=None)
def _reference_runs(tmp):
    _, params = _init()
    np.savez(os.path.join(tmp, "params.npz"), **_flat_np(params))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, tmp, str(KNOB_STEPS), str(SEQ), str(BATCH),
         str(LR), str(REG)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0 and "REF_OK" in out.stdout, out.stdout[-3000:] + out.stderr[-3000:]
    return {name: dict(np.load(os.path.join(tmp, name + ".npz"))) for name in ("accum2", "loss_fn")}


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    return _reference_runs(str(tmp_path_factory.mktemp("knobs_ref")))


def _custom_loss(cfg):
    return lambda p, b: tfm.loss_fn(p, cfg, b) + REG * torch.sum(p["final_norm.g"] ** 2)


def _port_run(fused, **kw):
    _, params = _init()
    cfg = tget_config("granite-8b-reduced")
    if kw.pop("custom_loss", False):
        kw["loss_fn"] = _custom_loss(cfg)
    trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                          fused_apply=fused, device="cpu", **kw)
    loss_fn, trainer.calls = trainer.loss_fn, []
    trainer.loss_fn = lambda p, b: trainer.calls.append(b["tokens"].shape[0]) or loss_fn(p, b)
    state = trainer.init_state(params=params_from_jax(params))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses = []
    for t in range(KNOB_STEPS):
        state, loss, _ = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
        losses.append(loss.numpy().copy())
    return state, trainer, np.stack(losses)


@pytest.mark.parametrize("case", ["accum2", "loss_fn"])
@pytest.mark.parametrize("fused", [False, True])
def test_knobs_match_the_reference_trainer(reference_runs, case, fused):
    kw = {"accum_steps": 2} if case == "accum2" else {"custom_loss": True}
    state, trainer, losses = _port_run(fused, **kw)
    want = reference_runs[case]
    np.testing.assert_allclose(losses, want["losses"], rtol=0, atol=5e-5)
    got = trainer.stacked_params(state)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want["p." + k], rtol=0, atol=5e-5, err_msg=k)
    # the knob took effect: two microbatches of one sequence per node and
    # step; the custom loss is not the plain one
    if case == "accum2":
        assert trainer.calls == [BATCH // 2] * (2 * G * KNOB_STEPS)
    else:
        _, _, plain = _port_run(fused)
        assert np.abs(plain - losses).min() > 1e-2


def test_microbatch_mean_matches_the_reference_grads_of():
    """One node: the port's accumulated loss and gradients against the
    reference's ``_grads_of`` scan (accum 2 and 4 of a batch of 4)."""
    jcfg, params = _init()
    tcfg = tget_config("granite-8b-reduced")
    layout = FlatLayout.from_shapes({k: d.shape for k, d in tfm.model_defs(tcfg).items()})
    theta = torch.empty((1, layout.size))
    for name, view in layout.views(theta[0]).items():
        view.copy_(params_from_jax(params)[name])
    batch = SyntheticLM(vocab=tcfg.vocab, seq_len=SEQ, seed=0).stacked(1, 0, 4)
    for accum in (2, 4):
        grad = torch.empty_like(theta)
        loss = node_grads_into(lambda p, b: tfm.loss_fn(p, tcfg, b), layout, theta, grad,
                               {k: torch.as_tensor(v) for k, v in batch.items()},
                               accum_steps=accum)
        micro = {k: jnp.asarray(v[0]).reshape((accum, 4 // accum) + v.shape[2:])
                 for k, v in batch.items()}

        def body(carry, mb):
            l, g = jax.value_and_grad(lambda p: jtfm.loss_fn(p, jcfg, mb))(params)
            return (carry[0] + l / accum,
                    jax.tree.map(lambda a, b: a + b / accum, carry[1], g)), None

        zero = (jnp.zeros((), jnp.float32), jax.tree.map(jnp.zeros_like, params))
        (jloss, jgrads), _ = jax.lax.scan(body, zero, micro)
        np.testing.assert_allclose(float(loss[0]), float(jloss), rtol=0, atol=5e-5)
        want = _flat_np(jax.device_get(jgrads))
        for name, view in layout.views(grad[0]).items():
            np.testing.assert_allclose(view.numpy(), want[name], rtol=0, atol=5e-5,
                                       err_msg=f"accum {accum} {name}")
    with pytest.raises(ValueError, match="microbatches"):
        node_grads_into(lambda p, b: tfm.loss_fn(p, tcfg, b), layout, theta,
                        torch.empty_like(theta),
                        {k: torch.as_tensor(v) for k, v in batch.items()}, accum_steps=3)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _remat_run(fused, remat, policy="full"):
    cfg = dataclasses.replace(tget_config("granite-8b-reduced"), remat=remat,
                              remat_policy=policy)
    trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                          collect_norms=True, fused_apply=fused, device="cpu")
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    for t in range(KNOB_STEPS):
        state, loss, nrm = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
        losses.append(loss.clone())
        norms.append(nrm.clone())
    return state, torch.stack(losses), torch.stack(norms)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("fused", [False, True])
def test_remat_on_equals_remat_off_bit_for_bit(fused, policy):
    off = _remat_run(fused, False)
    on = _remat_run(fused, True, policy)
    assert torch.equal(on[0].theta, off[0].theta)
    assert all(torch.equal(on[0].opt[k], off[0].opt[k]) for k in off[0].opt)
    assert torch.equal(on[1], off[1]) and torch.equal(on[2], off[2])


def test_remat_recomputes_the_layers_and_rejects_unknown_policies(monkeypatch):
    """With remat each block's forward runs twice per backward pass (once
    more when the gradients are taken); without it once."""
    calls = []
    orig = tfm.apply_attn_block
    monkeypatch.setattr(tfm, "apply_attn_block",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    base = tget_config("granite-8b-reduced")
    tok = torch.as_tensor(SyntheticLM(vocab=base.vocab, seq_len=SEQ, seed=0).stacked(1, 0, 2)
                          ["tokens"][0])
    for remat, want in ((False, base.n_layers), (True, 2 * base.n_layers)):
        cfg = dataclasses.replace(base, remat=remat)
        params = {k: v.requires_grad_() for k, v in
                  tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu").items()}
        calls.clear()
        tfm.forward(params, cfg, tok).float().sum().backward()
        assert len(calls) == want, (remat, calls)
    with torch.no_grad():   # serving keeps no activations: nothing to recompute
        calls.clear()
        tfm.forward(params, cfg, tok)
        assert len(calls) == base.n_layers
    bad = dataclasses.replace(base, remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        tfm.forward(params, bad, tok)


def test_dots_policy_recomputes_no_matrix_product():
    """The backward pass runs the products of the forward's recomputation
    under remat "full", none of them under "dots" (it keeps them)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func.overloadpacket.__name__ in ("mm", "bmm", "addmm", "baddbmm")
            return func(*args, **(kwargs or {}))

    base = tget_config("granite-8b-reduced")
    tok = torch.randint(0, base.vocab, (2, SEQ), generator=torch.Generator().manual_seed(0))
    counts = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        params = {k: v.requires_grad_() for k, v in
                  tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu").items()}
        loss = tfm.forward(params, cfg, tok).float().sum()
        with Count() as c:
            loss.backward()
        counts[(remat, policy)] = c.n
    assert counts[(True, "dots")] == counts[(False, "full")] < counts[(True, "full")]


def test_remat_gradients_match_the_reference_remat():
    jcfg, params = _init()
    jcfg = dataclasses.replace(jcfg, remat=True)
    tcfg = dataclasses.replace(tget_config("granite-8b-reduced"), remat=True)
    batch = SyntheticLM(vocab=tcfg.vocab, seq_len=SEQ, seed=0).stacked(1, 0, 2)
    jl, jg = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, {k: jnp.asarray(v[0]) for k, v in batch.items()}))(params)
    tparams = {k: v.requires_grad_() for k, v in params_from_jax(params).items()}
    tl = tfm.loss_fn(tparams, tcfg, {k: torch.as_tensor(v[0]) for k, v in batch.items()})
    tg = torch.autograd.grad(tl, list(tparams.values()))
    assert abs(float(tl.detach()) - float(jl)) <= 5e-5
    want = _flat_np(jax.device_get(jg))
    for name, g in zip(tparams, tg):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("node_loop", [False, True])
def test_simulator_with_remat_equals_without(node_loop):
    """The simulator's per-node loop takes the remat path; its vmapped
    gradients (a ``torch.func`` transform) run the layers as they are."""
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tget_config("granite-8b-reduced"), remat=remat)
        sim = DecentralizedSimulator(lambda p, b: tfm.loss_fn(p, cfg, b), sgd(0.9),
                                     make_topology("d_ring", G), node_loop=node_loop,
                                     device="cpu")
        state = sim.init(tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu"))
        src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
        for t in range(2):
            state, loss, _ = sim.train_step(state, src.stacked(G, t, BATCH), LR)
        out.append((state.theta.clone(), loss.clone()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# The data iterator and the examples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 5])
def test_node_batch_iterator_equals_the_reference(start):
    jsrc = JSyntheticLM(vocab=300, seq_len=12, seed=3)
    tsrc = SyntheticLM(vocab=300, seq_len=12, seed=3)
    jit = jnode_batch_iterator(jsrc, 4, 2, start_step=start, extra={"flag": 1})
    tit = node_batch_iterator(tsrc, 4, 2, start_step=start, extra={"flag": 1}, device="cpu")
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert set(jb) == set(tb) == {"tokens", "targets", "flag"} and tb["flag"] == 1
        for k in ("tokens", "targets"):
            assert isinstance(tb[k], torch.Tensor) and tb[k].device.type == "cpu"
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_quickstart_runs_and_its_loss_falls(capsys):
    out = quickstart.main(["--steps", "12"], device="cpu")
    hist = out["history"]["loss"]
    assert len(hist) == 12 and all(np.isfinite(hist))
    assert hist[-1] < hist[0] - 0.5
    text = capsys.readouterr().out
    assert "final mean-replica loss" in text and "gini(param norms)" in text


def test_dbench_whitebox_runs(capsys):
    out = dbench_whitebox.main(["--steps", "3", "--nodes", "8"], device="cpu")
    assert set(out["results"]) == set(dbench_whitebox.TOPOLOGIES)
    for r in out["results"].values():
        assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
        assert 0.0 <= r["final_eval"] <= 1.0
    assert set(out["ranks"]) == set(dbench_whitebox.TOPOLOGIES)
    assert "variance-rank integration" in capsys.readouterr().out


def test_examples_run_as_modules_and_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (quickstart, dbench_whitebox):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--steps", "1"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart", "--help"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0 and "--steps" in out.stdout
