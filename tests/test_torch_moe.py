"""Port parity: the MoE layer against ``repro.models.moe``.

The reference's parameters (``init_params(moe_defs(...))``) are carried
across; the same numpy tokens go through both.  The router's ids equal the
reference's ``lax.top_k`` ids and its weights are within 1e-6; the dispatch
(the stable sort, each assignment's slot and the capacity keep mask) equals
the reference's lines exactly, at ample and at tight capacity; outputs, the
aux loss and the gradients are within 1e-5.  Then the reference's five
properties of ``tests/test_moe.py`` on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import init_params as jinit_params  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.common import init_params as tinit_params  # noqa: E402
from repro_torch.models.common import unflatten_tree  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

torch.set_num_threads(1)


def _setup(seed=0, d=16, f=32, e=4, b=2, s=8, n_shared=0):
    jp = jinit_params(jmoe.moe_defs(d, f, e, n_shared=n_shared), jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    tp = unflatten_tree(params_from_jax(jax.device_get(jp)))
    return jp, tp, x


def _reference_dispatch(ids, e, capacity):
    """The reference's dispatch lines (``repro/models/moe.py::apply_moe``)."""
    t_k = ids.size
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = jnp.searchsorted(sorted_e, jnp.arange(e), side="left")
    pos = jnp.arange(t_k) - group_start[sorted_e]
    keep = pos < capacity
    return order, sorted_e, jnp.minimum(pos, capacity - 1), keep


@pytest.mark.parametrize("top_k,capacity", [(1, 64), (2, 64), (2, 3), (3, 2)])
def test_router_dispatch_and_output_match_reference(top_k, capacity):
    jp, tp, x = _setup(e=6, b=2, s=12)
    xt = x.reshape(-1, x.shape[-1])
    jw, jids = jmoe._top_k_router(jnp.asarray(xt) @ jp["router"], top_k)
    tw, tids = tmoe._top_k_router(torch.from_numpy(xt) @ tp["router"], top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    want = _reference_dispatch(jids, 6, capacity)
    got = tmoe.dispatch_slots(tids, 6, capacity)
    for name, a, b_ in zip(("order", "expert", "slot", "keep"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_), err_msg=name)
    if capacity < 64:
        assert not bool(got[3].all())   # this case drops assignments
    jo, jaux = jmoe.apply_moe(jp, jnp.asarray(x), top_k=top_k, capacity=capacity)
    to, taux = tmoe.apply_moe(tp, torch.from_numpy(x), top_k=top_k, capacity=capacity)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    assert abs(float(taux) - float(jaux)) < 1e-6


def test_capacity_rule_and_shared_experts_match_reference():
    jp, tp, x = _setup(seed=5, e=4, b=2, s=16, n_shared=1)
    assert tmoe.capacity_of(32, 2, 4, 1.25) == int(max(2 * 32 * 1.25 / 4, 4)) == 20
    assert tmoe.capacity_of(2, 2, 16, 1.25) == 4
    jo, jaux = jmoe.apply_moe(jp, jnp.asarray(x), top_k=2, capacity_factor=0.5)
    to, taux = tmoe.apply_moe(tp, torch.from_numpy(x), top_k=2, capacity_factor=0.5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    assert abs(float(taux) - float(jaux)) < 1e-6


def test_gradients_match_reference():
    jp, tp, x = _setup(seed=4, n_shared=1)
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.apply_moe(p, xx, top_k=2, capacity=5)
        return jnp.sum(out * w) + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    flat = params_from_jax(jax.device_get(jg))
    leaves = {k: v.requires_grad_() for k, v in params_from_jax(jax.device_get(jp)).items()}
    xx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.apply_moe(unflatten_tree(leaves), xx, top_k=2, capacity=5)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + 0.01 * aux,
                                list(leaves.values()) + [xx])
    for (name, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), flat[name].numpy(), atol=1e-5, err_msg=name)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), atol=1e-5)


def test_manual_ep_raises():
    with pytest.raises(ValueError, match="manual_ep"):
        tmoe.apply_moe_manual_ep()


# --- the reference's properties (tests/test_moe.py) on the port ------------------

def _tsetup(seed, d=16, f=32, e=4, b=2, s=8, n_shared=0):
    gen = torch.Generator().manual_seed(seed)
    params = tinit_params(tmoe.moe_defs(d, f, e, n_shared=n_shared), gen, "cpu")
    x = torch.randn((b, s, d), generator=gen)
    return params, x


def _dense_oracle(params, x, top_k):
    """Every token through every expert, weighted by its top-k gate."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt @ params["router"], -1)
    topw, topi = torch.topk(probs, top_k)
    topw = topw / topw.sum(-1, keepdim=True)
    gates = torch.zeros((xt.shape[0], e)).scatter(1, topi, topw)
    g = torch.einsum("td,edf->tef", xt, params["w_gate"])
    u = torch.einsum("td,edf->tef", xt, params["w_up"])
    out_e = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * u, params["w_down"])
    return torch.einsum("ted,te->td", out_e, gates).reshape(b, s, d)


@pytest.mark.parametrize("top_k", [1, 2])
def test_dispatch_matches_dense_oracle_with_ample_capacity(top_k):
    params, x = _tsetup(0)
    out, aux = tmoe.apply_moe(params, x, top_k=top_k, capacity=64)   # no drops
    torch.testing.assert_close(out, _dense_oracle(params, x, top_k), atol=1e-4, rtol=1e-4)
    assert 0.9 < float(aux) < 2.0


def test_capacity_drops_tokens_not_correctness():
    params, x = _tsetup(1, b=1, s=32)
    full, _ = tmoe.apply_moe(params, x, top_k=2, capacity=64)
    tight, _ = tmoe.apply_moe(params, x, top_k=2, capacity=2)
    assert bool(torch.isfinite(tight).all())
    assert float(tight.abs().sum()) < float(full.abs().sum()) + 1e-3


def test_balanced_router_aux_is_near_one():
    params, x = _tsetup(2, e=4, b=4, s=64)
    params["router"] = torch.zeros_like(params["router"])   # uniform logits
    _, aux = tmoe.apply_moe(params, x, top_k=2, capacity=256)
    assert 0.9 < float(aux) < 1.3


def test_shared_expert_adds_contribution():
    params, x = _tsetup(3, n_shared=1)
    with_shared, _ = tmoe.apply_moe(params, x, top_k=2, capacity=64)
    without, _ = tmoe.apply_moe({k: v for k, v in params.items() if k != "shared"}, x,
                                top_k=2, capacity=64)
    assert not torch.allclose(with_shared, without)


def test_moe_grads_flow_to_router_and_experts():
    params, x = _tsetup(4)
    params = {k: v.requires_grad_() for k, v in params.items()}
    out, aux = tmoe.apply_moe(params, x, top_k=2, capacity=64)
    grads = torch.autograd.grad(torch.mean(out ** 2) + 0.01 * aux, list(params.values()))
    for name, g in zip(params, grads):
        assert float(g.abs().sum()) > 0, name
