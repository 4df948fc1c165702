"""Port parity: the engines under faults on a mixed-dtype state (bf16
zamba2-reduced: its Mamba2 ``a_log``/``d_skip`` stay float32), with the
harness and bars of ``tests/test_torch_mixed.py``: a crash with a rejoin
and a join (the simulator grows; the trainer activates a spare rank), 6
steps, the simulator and the stacked trainer against the reference's
simulator step by step from the port's state, every narrow leaf a bfloat16
value after each step (and where the step's gradients and DBench norms
read it, after the handoff), and 4 gloo ranks bit for bit the stacked
rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_rank_worker as worker  # noqa: E402
from repro.core.dsgd import make_topology as jmake_topology  # noqa: E402
from repro.core.faults import make_fault_model as jmake_fault_model  # noqa: E402
from repro.core.simulator import DecentralizedSimulator as JSim  # noqa: E402
from repro.optim.sgd import sgd as jsgd  # noqa: E402
from repro_torch.core.dsgd import make_topology as tmake_topology  # noqa: E402
from repro_torch.core.faults import make_fault_model as tmake_fault_model  # noqa: E402
from repro_torch.core.simulator import DecentralizedSimulator as TSim  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.optim.sgd import sgd as tsgd  # noqa: E402
from test_torch_mixed import (  # noqa: E402
    LR, N, _bf16_exact, _check_leaves, _model, _ref_state, _tbatch, jquad_loss,
)

torch.set_num_threads(1)

CRASH = ("crash", dict(rate=0.5, seed=2, down_steps=2))   # node down at 1, back at 3


@pytest.mark.parametrize("fault", ["crash", "join"])
def test_simulator_under_faults_matches_the_reference(fault):
    """6 steps under a crash with a rejoin, or a join that grows 4 nodes
    to 5 at step 2; the port's state is every step's start for the
    reference's step."""
    tparams, _ = _model("zamba2")
    spec = CRASH if fault == "crash" else ("join", dict(join_steps=(2,)))
    name, kw = spec
    sim = TSim(worker.quad_loss, tsgd(0.9),
               tmake_topology("d_ring", N, fault_model=tmake_fault_model(name, N, **kw)),
               device="cpu")
    jsim = JSim(jquad_loss, jsgd(0.9),
                jmake_topology("d_ring", N, fault_model=jmake_fault_model(name, N, **kw)))
    state = sim.init(tparams)
    layout = state.layout
    jsim.init(_model("zamba2")[1])
    events = set()
    for t in range(6):
        n = len(sim.fault_model.at(t).alive)
        fr = sim.fault_model.at(t)
        events |= {k for k in ("rejoin", "joins") if getattr(fr, k)}
        before = state.theta.clone()
        jstate = _ref_state(layout, before, state.opt["mom"], t)
        jstate, jloss, _ = jsim.train_step(jstate, {
            k: jnp.asarray(v) for k, v in _tbatch(layout, n, t).items()}, LR)
        state, loss, _ = sim.train_step(state, _tbatch(layout, n, t), LR)
        assert state.theta.shape[0] == n and _bf16_exact(layout, state.theta), t
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5, atol=0)
        _check_leaves(layout, state.theta, state.opt["mom"], jstate.params,
                      jstate.opt_state, f"{fault} step {t}", before=before)
    assert events == ({"rejoin"} if fault == "crash" else {"joins"})


SPARE_JOIN = ("join", dict(join_steps=(2,), spare_ranks=1))


@pytest.mark.parametrize("fused", [False, True], ids=["interpreter", "fused"])
@pytest.mark.parametrize("fault", [CRASH, SPARE_JOIN], ids=["crash", "spare-join"])
def test_trainer_under_faults_matches_the_reference(fault, fused):
    """The stacked trainer, 6 steps, each from the port's state in the
    reference's simulator with stacked mixing (a join activates the spare
    rank: a rejoin); the interpreter's states at the item-1 bars.  The
    state the step's gradients and DBench norms see, after the rejoin's
    handoff, holds bfloat16 values in every narrow leaf, and the norms are
    the reference's (rtol 1e-5): a float32 mean left unrounded moves a
    rejoined node's norms by up to 2^-9 relative."""
    name, kw = fault
    cfg = worker.mixed_cfg()
    trainer = SPMDTrainer(
        cfg, tmake_topology("d_ring", N, fault_model=tmake_fault_model(name, N, **kw)),
        tsgd(0.9), loss_fn=worker.quad_loss, collect_norms=True, fused_apply=fused,
        device="cpu")
    jsim = JSim(jquad_loss, jsgd(0.9),
                jmake_topology("d_ring", N, fault_model=jmake_fault_model(name, N, **kw)),
                mixing="shift", collect_norms=True)
    state = trainer.init_state(params=_model("zamba2")[0])
    layout = trainer.layout
    jsim.init(_model("zamba2")[1])
    seen = []
    own = trainer._grads_into

    def grads_into(theta, grad, batch):
        seen.append(_bf16_exact(layout, theta))
        return own(theta, grad, batch)

    trainer._grads_into = grads_into
    rejoins = 0
    for t in range(6):
        rejoins += len(trainer.fault_model.at(t).rejoin)
        before = state.theta.clone()
        jstate = _ref_state(layout, before, state.mom, t)
        batch = _tbatch(layout, N, t)
        jstate, jloss, jnorms = jsim.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, LR)
        state, loss, norms = trainer.train_step(state, batch, LR)
        assert seen[-1] and _bf16_exact(layout, state.theta), t
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5, atol=0)
        np.testing.assert_allclose(norms.numpy(), np.asarray(jnorms), rtol=1e-5, atol=0,
                                   err_msg=f"norms at step {t}")
        if not fused:   # the reference's simulator has no fused step (its
            # K1 runs on float32 θ* and wire: tests/test_torch_zoo_train.py)
            _check_leaves(layout, state.theta, state.mom, jstate.params, jstate.opt_state,
                          f"step {t}", before=before)
    assert rejoins == 1


@pytest.mark.parametrize("fault", [CRASH, SPARE_JOIN], ids=["crash", "spare-join"])
def test_ranks_under_faults_equal_the_stacked_rows(fault, tmp_path):
    """4 gloo ranks (K2's twin, the handoffs across ranks) bit for bit the
    stacked fused trainer's rows (K1's twin), every narrow leaf a bfloat16
    value after each step on every rank."""
    name, kw = fault
    trainer = SPMDTrainer(
        worker.mixed_cfg(),
        tmake_topology("d_ring", N, fault_model=tmake_fault_model(name, N, **kw)),
        tsgd(0.9), loss_fn=worker.quad_loss, fused_apply=True, device="cpu")
    state = trainer.init_state(seed=0)
    for t in range(6):
        state, _, _ = trainer.train_step(state, _tbatch(trainer.layout, N, t), LR)
        assert _bf16_exact(trainer.layout, state.theta), t
    rows = spawn_world(worker.mixed_fault_rows, N, (fault, 6, LR), timeout=300,
                       device="cpu", workdir=tmp_path)
    for r, (theta, mom, exact, engine) in enumerate(rows):
        assert engine == "ranks" and all(exact), (r, exact)
        assert torch.equal(torch.from_numpy(theta), state.theta[r]), r
        assert torch.equal(torch.from_numpy(mom), state.mom[r]), r
