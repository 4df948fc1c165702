"""Port parity: the paper's models (mini ResNet, LSTM LM) and the nested
``ParamDef`` trees against ``repro.models``.

The reference's weights (``init_params`` from a PRNG key) and batches
(``synthetic_images`` exported as numpy, ``SyntheticLM`` tokens with some
targets masked to -1) go through the reference and the port.  Bars: losses
within rtol 1e-5, gradients within 1e-5 (absolute); the port's gradients
under ``torch.func.vmap`` over three nodes equal its per-node gradients.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import SyntheticLM  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

torch.set_num_threads(1)


def _jax_params(defs, seed):
    return jax.device_get(jcommon.init_params(defs, jax.random.PRNGKey(seed)))


def _resnet_case(channels=8, depth=2, batch=6, size=8, seed=0):
    jdefs = jpm.mini_resnet_defs(channels=channels, depth=depth)
    params = _jax_params(jdefs, seed)
    b = jax.device_get(jpm.synthetic_images(jax.random.PRNGKey(seed + 1),
                                            batch=batch, size=size))
    return params, {"images": np.asarray(b["images"]), "labels": np.asarray(b["labels"])}


def _lstm_case(vocab=32, d=16, batch=3, seq=7, seed=0):
    params = _jax_params(jpm.lstm_defs(vocab=vocab, d=d), seed)
    b = SyntheticLM(vocab=vocab, seq_len=seq, seed=seed).stacked(1, 0, batch)
    b = {k: v[0] for k, v in b.items()}
    b["targets"] = b["targets"].copy()
    b["targets"][0, -2:] = -1   # masked positions take no part in the loss
    return params, b


CASES = {
    "mini_resnet": (_resnet_case, jpm.mini_resnet_loss, tpm.mini_resnet_loss),
    "mini_resnet_depth3": (lambda: _resnet_case(channels=4, depth=3, seed=3),
                           jpm.mini_resnet_loss, tpm.mini_resnet_loss),
    "lstm": (_lstm_case, jpm.lstm_loss, tpm.lstm_loss),
}


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_reference(case):
    make, jloss, tloss = CASES[case]
    params, batch = make()
    jl, jg = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(params)
    tg, tl = torch.func.grad_and_value(tloss)(tp, _torch_batch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = params_from_jax(jax.device_get(jg))
    assert list(tg) == list(want)
    for k in want:
        np.testing.assert_allclose(tg[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["mini_resnet", "lstm"])
def test_nested_params_equal_flat_params(case):
    make, _, tloss = CASES[case]
    params, batch = make()
    nested = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    flat = params_from_jax(params)
    b = _torch_batch(batch)
    assert float(tloss(nested, b)) == float(tloss(flat, b))


@pytest.mark.parametrize("case", ["mini_resnet", "lstm"])
def test_vmap_over_nodes_equals_per_node_grads(case):
    make, _, tloss = CASES[case]
    params, batch = make()
    tp = params_from_jax(params)
    rng = np.random.default_rng(0)
    stacked = {k: torch.stack([v + 0.01 * i * torch.from_numpy(
        rng.standard_normal(v.shape).astype(np.float32)) for i in range(3)])
        for k, v in tp.items()}
    b = {k: torch.stack([v] * 3) for k, v in _torch_batch(batch).items()}
    g, l = torch.func.vmap(torch.func.grad_and_value(tloss))(stacked, b)
    for i in range(3):
        gi, li = torch.func.grad_and_value(tloss)(
            {k: v[i] for k, v in stacked.items()}, {k: v[i] for k, v in b.items()})
        np.testing.assert_allclose(float(l[i]), float(li), rtol=1e-6)
        for k in gi:
            np.testing.assert_allclose(g[k][i].numpy(), gi[k].numpy(), rtol=0, atol=1e-6)


def test_perplexity_is_exp_loss():
    params, batch = _lstm_case()
    j = float(jpm.lstm_perplexity(jax.tree.map(jnp.asarray, params),
                                  {k: jnp.asarray(v) for k, v in batch.items()}))
    t = float(tpm.lstm_perplexity(params_from_jax(params), _torch_batch(batch)))
    np.testing.assert_allclose(t, j, rtol=1e-5)


@pytest.mark.parametrize("defs", [
    lambda m: m.mini_resnet_defs(channels=4, depth=3),
    lambda m: m.lstm_defs(vocab=11, d=6),
], ids=["mini_resnet", "lstm"])
def test_param_trees_match_reference(defs):
    """Leaf names and shapes in ``jax.tree.leaves`` order, and the count."""
    jd, td = defs(jpm), defs(tpm)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jd, is_leaf=lambda x: isinstance(x, jcommon.ParamDef))[0]
    jnames = [".".join(str(p.key) for p in path) for path, _ in jleaves]
    flat = tcommon.flatten_tree(td)
    assert list(flat) == jnames
    assert [d.shape for d in flat.values()] == [d.shape for _, d in jleaves]
    assert tcommon.param_count(td) == jcommon.param_count(jd)
    gen = torch.Generator().manual_seed(0)
    tp = tcommon.init_params(td, gen, "cpu")
    assert list(tcommon.flatten_tree(tp)) == jnames
    assert tcommon.param_count(tp) == tcommon.param_count(td)


def test_resnet_leaf_order_is_sorted_per_level():
    names = list(tcommon.flatten_tree(tpm.mini_resnet_defs(depth=2)))
    assert names == ["block0.conv1", "block0.conv2", "block0.g1", "block0.g2",
                     "block1.conv1", "block1.conv2", "block1.g1", "block1.g2",
                     "head", "head_b", "stem"]


def test_synthetic_images_shape_and_determinism():
    a = tpm.synthetic_images(torch.Generator().manual_seed(3), batch=5, size=8)
    b = tpm.synthetic_images(torch.Generator().manual_seed(3), batch=5, size=8)
    assert a["images"].shape == (5, 8, 8, 3) and a["images"].dtype == torch.float32
    assert a["labels"].shape == (5,) and int(a["labels"].max()) < 10
    assert torch.equal(a["images"], b["images"]) and torch.equal(a["labels"], b["labels"])
    # the prototypes are fixed: the same label gives images a noise apart
    c = tpm.synthetic_images(torch.Generator().manual_seed(4), batch=64, size=8, noise=0.0)
    lab = c["labels"]
    same = [(i, j) for i in range(64) for j in range(i + 1, 64) if lab[i] == lab[j]]
    i, j = same[0]
    assert torch.equal(c["images"][i], c["images"][j])
