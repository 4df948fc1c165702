"""Port parity: the optimizers against ``repro.optim.sgd``.

Mirrors ``tests/test_optim.py``: ``sgd`` (momentum, nesterov, weight
decay, momentumless), ``adamw`` and ``lars`` take 5 steps on the same
numpy parameters and gradients as the reference, within 1e-6 (parameters
and every state leaf).  Under ``torch.func.vmap`` over the node axis, as
the engines run them, they equal the per-node updates (LARS's norms stay
per node), and the state converts to and from its flat slots.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)
# the optimizer modules (their packages export the function ``sgd`` by that name)
jopt = importlib.import_module("repro.optim.sgd")
topt = importlib.import_module("repro_torch.optim.sgd")

CASES = {
    "sgd-momentum": ("sgd", dict(momentum=0.9), 0.1),
    "sgd-nesterov-wd": ("sgd", dict(momentum=0.9, nesterov=True, weight_decay=1e-2), 0.1),
    "sgd-plain-wd": ("sgd", dict(momentum=0.0, weight_decay=0.1), 0.1),
    "adamw": ("adamw", {}, 1e-2),
    "adamw-no-wd": ("adamw", dict(b1=0.8, b2=0.99, weight_decay=0.0), 3e-3),
    "lars": ("lars", {}, 0.5),
    "lars-trust": ("lars", dict(momentum=0.5, trust_coefficient=0.01), 2.0),
}


def _inputs(seed, zero_leaf=False):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    if zero_leaf:   # LARS's trust ratio falls back to 1 on a zero norm
        params["z"] = np.zeros(2, np.float32)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    return params, grads


def _flat_state(state):
    """Every leaf of a state as numpy, keyed by path."""
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _torch_state(state):
    if isinstance(state, torch.Tensor):
        return {"": state.numpy()}
    out = {}
    for k, v in (state.items() if isinstance(state, dict) else []):
        for kk, vv in _torch_state(v).items():
            out[f"[{k!r}]" + kk] = vv
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_five_steps_match_reference(case):
    name, kw, lr = CASES[case]
    params, grads = _inputs(1, zero_leaf=name == "lars")
    jo, to = jopt.get_optimizer(name, **kw), topt.get_optimizer(name, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, lr)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        want, got = _flat_state(js), _torch_state(ts)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_vmapped_update_equals_per_node_and_round_trips_its_slots(case):
    name, kw, lr = CASES[case]
    opt = topt.get_optimizer(name, **kw)
    nodes = [_inputs(s) for s in range(3)]
    stacked_p = {k: torch.stack([torch.from_numpy(p[k]) for p, _ in nodes])
                 for k in nodes[0][0]}
    stacked_g = {k: torch.stack([torch.from_numpy(g[0][k]) for _, g in nodes])
                 for k in nodes[0][0]}
    states = [opt.init({k: torch.from_numpy(v) for k, v in p.items()}) for p, _ in nodes]
    parts, t = topt.state_parts(opt, states[0])
    assert sorted(parts) == sorted(opt.slots) and (t is not None) == opt.counted
    stacked_parts = {s: {k: torch.stack([topt.state_parts(opt, st)[0][s][k] for st in states])
                         for k in stacked_p} for s in opt.slots}
    st = topt.state_from(opt, stacked_parts,
                         None if t is None else torch.stack([t] * 3))
    new_p, new_st = torch.func.vmap(opt.update, in_dims=(0, 0, 0, None))(
        stacked_g, st, stacked_p, lr)
    new_parts, new_t = topt.state_parts(opt, new_st)
    for i, (p, g) in enumerate(nodes):
        want_p, want_st = opt.update({k: torch.from_numpy(v) for k, v in g[0].items()},
                                     states[i], {k: torch.from_numpy(v) for k, v in p.items()},
                                     lr)
        want_parts, want_t = topt.state_parts(opt, want_st)
        for k in p:
            np.testing.assert_allclose(new_p[k][i].numpy(), want_p[k].numpy(), rtol=0, atol=1e-7)
            for s in opt.slots:
                np.testing.assert_allclose(new_parts[s][k][i].numpy(),
                                           want_parts[s][k].numpy(), rtol=0, atol=1e-7)
        if opt.counted:
            assert int(new_t[i]) == int(want_t) == 1


def test_manual_values():
    opt = topt.get_optimizer("sgd", momentum=0.9)
    p = {"w": torch.tensor([1.0, 2.0])}
    g = {"w": torch.tensor([0.5, -1.0])}
    p1, st1 = opt.update(g, opt.init(p), p, 0.1)
    np.testing.assert_allclose(p1["w"].numpy(), [0.95, 2.1], atol=1e-6)
    p2, _ = opt.update(g, st1, p1, 0.1)
    np.testing.assert_allclose(float(p2["w"][0]), float(p1["w"][0]) - 0.1 * 0.95, atol=1e-6)
    a = topt.get_optimizer("adamw", weight_decay=0.0)
    pa, _ = a.update({"w": torch.tensor([3.0])}, a.init({"w": torch.tensor([0.0])}),
                     {"w": torch.tensor([0.0])}, 1e-2)
    np.testing.assert_allclose(pa["w"].numpy(), [-1e-2], rtol=1e-4)
    lars = topt.get_optimizer("lars", momentum=0.0, weight_decay=0.0, trust_coefficient=0.01)
    pl, _ = lars.update({"w": torch.full((4,), 1.0)}, lars.init({"w": torch.full((4,), 10.0)}),
                        {"w": torch.full((4,), 10.0)}, 1.0)
    np.testing.assert_allclose(pl["w"].numpy(), 10.0 - 0.1, rtol=1e-5)


def test_all_optimizers_descend_quadratic():
    target = torch.arange(4.0)
    for name, lr in [("sgd", 0.1), ("adamw", 0.05), ("lars", 5.0)]:
        opt = topt.get_optimizer(name)
        p = {"w": torch.zeros(4)}
        st = opt.init(p)
        for _ in range(200):
            g = torch.func.grad(lambda pp: torch.sum((pp["w"] - target) ** 2))(p)
            p, st = opt.update(g, st, p, lr)
        assert float(torch.linalg.norm(p["w"] - target)) < 0.5, name


def test_optimizer_metadata():
    assert topt.sgd(0.0).slots == () and topt.sgd(0.9).slots == ("mom",)
    assert topt.adamw().slots == ("mu", "nu") and topt.adamw().counted
    assert topt.lars().hyper["kind"] == "lars" and topt.adamw().hyper["kind"] == "adamw"
    for name in ("sgd", "adamw", "lars"):
        assert topt.get_optimizer(name).name == jopt.get_optimizer(name).name
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("rmsprop")
