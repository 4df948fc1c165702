"""Port parity: a mixed-dtype model (bfloat16 leaves beside float32 ones)
in the simulator, in buckets and under faults.

The port holds such a state in float32 with each narrower leaf's columns
holding values of its own dtype.  The models: zamba2-7b-reduced in
bfloat16 (its Mamba2 ``a_log``/``d_skip`` stay float32) and a two-leaf toy
(``a`` bfloat16, ``b`` float32).  Where the reference runs the same step,
both packages take the same gradients from ``quad_loss`` (``x - target``
in float32, rounded to each leaf's dtype), and each step starts from the
port's state in both packages, so a bfloat16 rounding flip of the mix
(float32 sums in another order) is not carried into later steps.  Bars, as
``tests/test_torch_zoo_train.py`` holds bf16 zamba2's step: float32 leaves
and the momentum within 1e-6 of the leaf's scale, bfloat16 leaves within
one bfloat16 ulp plus 1e-6 of the scale, losses within rtol 1e-5 (sums of
10⁴ in float32 in another order).

* the simulator: against the reference's simulator (d_ring and
  d_one_peer_exp, sgd 0.9, 3 steps), and bit for bit the port's stacked
  trainer without fused apply on the real zamba2 loss;
* ``bucket_mb``: the bucketed simulator bit for bit the monolithic one; the
  folded Ξ against the standalone probe within 1e-6 relative;
* the handoffs (rejoin, drain, join) on a mixed state: the reference's
  per-leaf results.  The engines under faults: ``test_torch_mixed_faults.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_rank_worker as worker  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.dsgd import make_topology as jmake_topology  # noqa: E402
from repro.core.simulator import DecentralizedSimulator as JSim  # noqa: E402
from repro.core.simulator import SimState as JState  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim.sgd import sgd as jsgd  # noqa: E402
from repro_torch.core.buckets import xi_from_folded_sq  # noqa: E402
from repro_torch.core.consensus import consensus_distance_stacked  # noqa: E402
from repro_torch.core.dsgd import make_topology as tmake_topology  # noqa: E402
from repro_torch.core.simulator import DecentralizedSimulator as TSim  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.optim.sgd import sgd as tsgd  # noqa: E402

torch.set_num_threads(1)

N, LR = 4, 0.05


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *head, last = k.split(".")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def jquad_loss(p, b):
    return 0.5 * sum(jnp.sum((x.astype(jnp.float32) - b[k]) ** 2) for k, x in _flat(p).items())


@functools.lru_cache(maxsize=None)
def _model(name):
    """(port leaves {name: tensor}, reference tree of jnp leaves)."""
    if name == "toy":
        r = np.random.default_rng(0)
        a, b = r.normal(size=(4,)).astype(np.float32), r.normal(size=(3,)).astype(np.float32)
        return ({"a": torch.from_numpy(a).bfloat16(), "b": torch.from_numpy(b)},
                {"a": jnp.asarray(a, jnp.bfloat16), "b": jnp.asarray(b)})
    jcfg = dataclasses.replace(jget_config("zamba2-7b-reduced"), remat=False,
                               dtype=jnp.bfloat16)
    params = jax.device_get(jax.jit(lambda k: jtfm.init_model(jcfg, k, tp_size=1))(
        jax.random.PRNGKey(42)))
    return params_from_jax(params), jax.tree.map(jnp.asarray, params)


def _ref_state(layout, theta, mom, step):
    """The reference's ``SimState`` holding the port's flat state: each leaf
    in its own dtype (exact: the narrow columns hold values of it)."""
    p = {k: jnp.asarray(v.numpy()).astype(jnp.dtype(str(dt).split(".")[-1]))
         for (k, v), dt in zip(layout.stacked_views(theta).items(), layout.dtypes)}
    m = {k: jnp.asarray(v.numpy()) for k, v in layout.stacked_views(mom).items()}
    return JState(params=_nest(p), opt_state=_nest(m), step=step)


def _bf16_exact(layout, theta):
    return all(torch.equal(theta[:, a:b], theta[:, a:b].to(dt).float())
               for a, b, dt in layout.narrow_leaves())


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _check_leaves(layout, theta, mom, want_p, want_m, label, before=None):
    """The item-1 bars: float32 leaves and m within 1e-6 of scale, bf16
    leaves within one bf16 ulp plus 1e-6 of scale.  After a mix (``before``:
    the port's θ before the step) a bf16 element may also be off by one
    bf16 ulp of its column's terms: the reference's jitted update contracts
    θ − lr·m' into a fused multiply-add, so its θ* can round to the
    neighbouring bf16 value, which the mix carries at weight ≤ 1."""
    wp, wm = _flat(jax.device_get(want_p)), _flat(jax.device_get(want_m))
    prior = {} if before is None else layout.stacked_views(before)
    for (name, v), dt in zip(layout.stacked_views(theta).items(), layout.dtypes):
        want = np.asarray(jnp.asarray(wp[name], jnp.float32))
        got = v.numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        bar = 1e-6 * scale
        if dt == torch.bfloat16:
            bar = bar + _bf16_ulp(want)
            if name in prior:
                terms = np.maximum(np.abs(prior[name].numpy()).max(0), np.abs(want).max(0))
                bar = bar + _bf16_ulp(2 * terms)[None]
        assert np.all(np.abs(got - want) <= bar), (label, name)
    for name, v in layout.stacked_views(mom).items():
        want = np.asarray(wm[name])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(v.numpy(), want, atol=1e-6 * scale, rtol=0,
                                   err_msg=f"{label} m {name}")


def _tbatch(layout, n, step):
    return worker.quad_batch(layout, n, step)


# ---------------------------------------------------------------------------
# 1. the simulator on a mixed-dtype model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["toy", "zamba2"])
@pytest.mark.parametrize("topo", ["d_ring", "d_one_peer_exp"])
def test_simulator_takes_a_mixed_model_and_matches_the_reference(model, topo):
    tparams, jparams = _model(model)
    sim = TSim(worker.quad_loss, tsgd(0.9), tmake_topology(topo, N), device="cpu")
    state = sim.init(tparams)   # raised "the flat state holds one dtype" before
    layout = state.layout
    assert layout.mixed and state.theta.dtype == torch.float32
    jsim = JSim(jquad_loss, jsgd(0.9), jmake_topology(topo, N))
    box = {"state": state}
    # the reference's first step from the replicated weights, then each
    # step from the port's state
    jstate, jloss, _ = jsim.train_step(jsim.init(jparams), {
        k: jnp.asarray(v) for k, v in _tbatch(layout, N, 0).items()}, LR)

    def port_step(t):
        box["state"], loss, _ = sim.train_step(box["state"], _tbatch(layout, N, t), LR)
        return box["state"].theta, box["state"].opt["mom"], loss

    theta, mom, loss = port_step(0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5, atol=0)
    _check_leaves(layout, theta, mom, jstate.params, jstate.opt_state, "step 0")
    for t in range(1, 3):
        theta0, mom0 = (x.clone() for x in (box["state"].theta, box["state"].opt["mom"]))
        jstate, jloss, _ = jsim.train_step(_ref_state(layout, theta0, mom0, t), {
            k: jnp.asarray(v) for k, v in _tbatch(layout, N, t).items()}, LR)
        theta, mom, loss = port_step(t)
        assert _bf16_exact(layout, theta), t
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5, atol=0)
        _check_leaves(layout, theta, mom, jstate.params, jstate.opt_state, f"step {t}",
                      before=theta0)
    # the final model, the probes and checkpoints read each leaf in its dtype
    mean = box["state"].mean_params()
    assert {k: v.dtype for k, v in mean.items()} == {k: v.dtype for k, v in tparams.items()}
    tree = sim.checkpoint_tree(box["state"])
    leaves = _flat(tree["p"])
    for name, dt in zip(layout.names, layout.dtypes):
        assert getattr(leaves[name], "dtype", None) == dt, name


def test_simulator_equals_the_unfused_trainer_bit_for_bit():
    """The real zamba2-reduced bf16 loss, one node's gradients at a time,
    stacked mixing: 3 steps of the simulator == 3 steps of ``SPMDTrainer``
    without fused apply (θ, m, losses, norms), as phase 13 holds granite."""
    cfg = worker.mixed_cfg()
    tparams, _ = _model("zamba2")
    loss_fn = lambda p, b: ttfm.loss_fn(p, cfg, b)
    sim = TSim(loss_fn, tsgd(0.9), tmake_topology("d_ring", N), mixing="shift",
               node_loop=True, collect_norms=True, device="cpu")
    trainer = SPMDTrainer(cfg, tmake_topology("d_ring", N), tsgd(0.9), collect_norms=True,
                          device="cpu")
    s_state, t_state = sim.init(tparams), trainer.init_state(params=tparams)
    assert s_state.layout == trainer.layout
    src = SyntheticLM(vocab=cfg.vocab, seq_len=16, seed=0)
    for t in range(3):
        b = src.stacked(N, t, 2)
        s_state, s_loss, s_norms = sim.train_step(s_state, b, LR)
        t_state, t_loss, t_norms = trainer.train_step(t_state, b, LR)
        assert torch.equal(s_loss, t_loss) and torch.equal(s_norms, t_norms), t
    assert torch.equal(s_state.theta, t_state.theta)
    assert torch.equal(s_state.opt["mom"], t_state.mom)
    assert _bf16_exact(trainer.layout, s_state.theta)


# ---------------------------------------------------------------------------
# 2. bucket_mb on a mixed-dtype state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixing", ["shift", "dense"])
def test_bucketed_simulator_is_the_monolithic_one(mixing):
    """1 MiB (13 buckets) and one bucket: 2 steps of d_one_peer_exp with 2
    rounds a gossip, bit for bit the leaf-by-leaf step."""
    tparams, _ = _model("zamba2")
    runs = {}
    for mb in (None, 1, 1e6):
        sim = TSim(worker.quad_loss, tsgd(0.9), tmake_topology("d_one_peer_exp", N),
                   mixing=mixing, mix_rounds=2, bucket_mb=mb, device="cpu")
        state = sim.init(tparams)
        for t in range(2):
            state, loss, _ = sim.train_step(state, _tbatch(state.layout, N, t), LR)
        runs[mb] = (state.theta, state.opt["mom"], loss)
    for mb in (1, 1e6):
        for got, want in zip(runs[mb], runs[None]):
            assert torch.equal(got, want), mb
    assert _bf16_exact(state.layout, runs[None][0])


def test_folded_xi_on_a_mixed_state_equals_the_standalone_probe():
    """The closed loop bucketed at 1 MiB from replicas pushed apart (and
    rounded back to their leaves' dtypes): each step's folded Ξ within
    1e-6 relative of the standalone probe of the state it was folded
    over, fused and interpreted."""
    cfg = worker.mixed_cfg()
    for fused in (True, False):
        topo = tmake_topology("d_ada", N, k_floor="one_peer", consensus_target=0.7,
                              consensus_probe_every=1)
        trainer = SPMDTrainer(cfg, topo, tsgd(0.9), loss_fn=worker.quad_loss,
                              fused_apply=fused, bucket_mb=1, device="cpu")
        state = trainer.init_state(seed=0)
        gen = torch.Generator().manual_seed(3)
        state.theta.add_(0.01 * torch.randn(state.theta.shape, generator=gen))
        trainer.layout.round_leaves_(state.theta)
        for t in range(3):
            state, _, _ = trainer.train_step(state, _tbatch(trainer.layout, N, t), LR)
            assert trainer._fold.step == t + 1
            folded = xi_from_folded_sq(trainer._fold.sq)
            want = float(consensus_distance_stacked(state.theta))
            assert folded == pytest.approx(want, rel=1e-6), (fused, t)
            assert _bf16_exact(trainer.layout, state.theta)


# ---------------------------------------------------------------------------
# 3. the handoffs on a mixed state
# ---------------------------------------------------------------------------

def test_handoffs_round_the_narrow_leaves_as_the_reference_does():
    """adopt, drain and admit on a (5, 7) float32 buffer whose columns 0:4
    hold a bfloat16 leaf and 4:7 a float32 one: the reference's per-leaf
    results (its float32 mean cast to the leaf's dtype; its drain adds Δ
    cast to the leaf's dtype in that dtype): the bfloat16 columns exactly."""
    from repro.core import faults as jfaults
    from repro_torch.core import faults as tfaults

    r = np.random.default_rng(7)
    a = jnp.asarray(r.normal(size=(5, 4)), jnp.bfloat16)
    b = jnp.asarray(r.normal(size=(5, 3)).astype(np.float32))
    tree = {"a": a, "b": b}
    flat = torch.from_numpy(np.concatenate([np.asarray(a.astype(jnp.float32)),
                                            np.asarray(b)], 1))
    narrow = ((0, 4, torch.bfloat16),)
    alive = np.array([1, 1, 0, 1, 1])

    def as_flat(t):
        return np.concatenate([np.asarray(t["a"].astype(jnp.float32)), np.asarray(t["b"])], 1)

    def same(got, want):
        """bfloat16 columns exactly; float32 ones within their rounding (the
        reference's mean sums in another order)."""
        np.testing.assert_array_equal(got[:, :4], want[:, :4])
        np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=1e-6, atol=0)

    got = flat.clone()
    tfaults.adopt_neighbor_average(got, 2, [1, 3, 4], narrow=narrow)
    same(got.numpy(), as_flat(jfaults.adopt_neighbor_average(tree, 2, [1, 3, 4])))
    got = flat.clone()
    tfaults.drain_handoff(got, 0, [1, 4], alive, narrow=narrow)
    same(got.numpy(), as_flat(jfaults.drain_handoff(tree, 0, [1, 4], alive)))
    same(tfaults.admit_node(flat, [0, 3], narrow=narrow).numpy(),
         as_flat(jfaults.admit_node(tree, [0, 3])))
    # without the narrow table the float32 mean is not a bfloat16 value
    got = flat.clone()
    tfaults.adopt_neighbor_average(got, 2, [1, 3, 4])
    assert not torch.equal(got[2, :4], got[2, :4].bfloat16().float())
