"""Port parity: the dense transformer against ``repro.models.transformer``.

granite-8b-reduced in float32: the reference's weights are carried across
with ``params_from_jax``; loss and every gradient leaf agree within
atol 1e-5 (float32 both sides, matmuls at full precision).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

torch.set_num_threads(1)


def _flat_np(tree, prefix=""):
    """Reference tree -> {dotted path: numpy} in leaf order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def granite():
    jcfg = dataclasses.replace(jget_config("granite-8b-reduced"), remat=False)
    tcfg = tget_config("granite-8b-reduced")
    jparams = jax.jit(lambda k: jtfm.init_model(jcfg, k, tp_size=1))(jax.random.PRNGKey(7))
    batch = SyntheticLM(vocab=jcfg.vocab, seq_len=16, seed=3).sample(0, 0, 2)
    return jcfg, tcfg, jparams, batch


def test_config_and_layout_match_reference(granite):
    jcfg, tcfg, jparams, _ = granite
    for f in ("n_layers", "d_model", "d_ff", "vocab", "n_heads", "n_kv", "head_dim"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.dtype == torch.float32
    full = tget_config("granite-8b")
    assert (full.d_model, full.n_heads, full.n_kv, full.d_ff, full.vocab) == (
        4096, 32, 8, 14336, 49152)
    assert full.dtype == torch.bfloat16
    defs = ttfm.model_defs(tcfg)
    flat = _flat_np(jparams)
    assert list(defs) == list(flat)  # reference leaf order
    for k, d in defs.items():
        assert d.shape == flat[k].shape, k
    qwen = tget_config("qwen2.5-14b")   # every reference arch loads
    assert (qwen.n_heads, qwen.n_kv, qwen.qkv_bias) == (40, 8, True)
    with pytest.raises(ValueError, match="unknown arch"):
        tget_config("qwen9-1t")


def test_loss_and_grads_match_reference(granite):
    jcfg, tcfg, jparams, batch = granite
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtfm.loss_fn(p, jcfg, b)))(jparams, jbatch)
    params = {k: v.requires_grad_() for k, v in ttfm.params_from_jax(
        jax.device_get(jparams)).items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = ttfm.loss_fn(params, tcfg, tbatch)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    want = _flat_np(jax.device_get(jgrads))
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5, rtol=0, err_msg=name)


def test_params_from_jax_carries_bf16_bits():
    x = np.asarray(jnp.asarray([[1.5, -2.25], [3e-3, 7.0]], jnp.bfloat16))
    got = ttfm.params_from_jax({"w": {"b": x}})
    assert list(got) == ["w.b"] and got["w.b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w.b"].float().numpy(), x.astype(np.float32))


def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    g = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g))), atol=1e-6)
    np.testing.assert_allclose(
        tcommon.layer_norm(*(torch.from_numpy(a) for a in (x, g, b))).numpy(),
        np.asarray(jcommon.layer_norm(*(jnp.asarray(a) for a in (x, g, b)))), atol=1e-5)
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0)
    q = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    js, jc = jcommon.rope(jnp.asarray(pos), 16)
    ts, tc = tcommon.rope(torch.from_numpy(pos), 16)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(q), ts, tc).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(q), js, jc)), atol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_reference_attention_matches(window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 9, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0)
    want = jattn.multihead_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_positions=jnp.asarray(pos),
        k_positions=jnp.asarray(pos), window=window)
    got = tattn.multihead_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), q_positions=torch.from_numpy(pos),
        k_positions=torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="unknown attention impl"):   # as the reference
        tattn.multihead_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), q_positions=torch.from_numpy(pos),
            k_positions=torch.from_numpy(pos), impl="pallas")
