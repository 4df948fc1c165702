"""Port parity: serving against ``repro.models.attention``,
``repro.models.transformer`` and ``repro.launch.serve``.

The same numpy inputs (and, for the model, the reference's weights carried
across with ``params_from_jax``) go through both packages in float32.
Bars: the attention paths within 1e-5 (the reference's own bar in
``tests/test_attention.py``); prefill, the decode chain and the ring decode
within 1e-4 absolute (measured on granite-8b-reduced, whose logits are
O(1): logits ≤ 2.4e-6, cached k/v ≤ 6.0e-6); greedy generation gives the
same tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

torch.set_num_threads(1)

B, S, H, KV, D = 2, 16, 4, 2, 8
MODEL_TOL = 1e-4


def _attn_inputs(seed, sq=S, sk=S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, sk, KV, D)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(sq, dtype=np.int32)[None], (B, sq)).copy()
    kpos = np.broadcast_to(np.arange(sk, dtype=np.int32)[None], (B, sk)).copy()
    valid = rng.random((B, sk)) > 0.2
    return q, k, v, qpos, kpos, valid


@pytest.mark.parametrize("impl", ["reference", "chunked", "chunked_skip"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("with_valid", [False, True])
def test_multihead_attention_matches_reference(impl, causal, window, with_valid):
    q, k, v, qpos, kpos, valid = _attn_inputs(0)

    def call(lib, q, k, v, qpos, kpos, valid):
        return lib.multihead_attention(
            q, k, v, q_positions=qpos, k_positions=kpos, causal=causal, window=window,
            k_valid=valid if with_valid else None, impl=impl, chunk_size=5)

    want = call(jattn, *(jnp.asarray(a) for a in (q, k, v, qpos, kpos, valid)))
    got = call(tattn, *(torch.from_numpy(a) for a in (q, k, v, qpos, kpos, valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_unknown_attention_impl_raises():
    q, k, v, qpos, kpos, _ = (torch.from_numpy(a) for a in _attn_inputs(1))
    for impl in ("pallas", "flash"):
        with pytest.raises(ValueError, match="unknown attention impl"):
            tattn.multihead_attention(q, k, v, q_positions=qpos, k_positions=kpos, impl=impl)


@pytest.mark.parametrize("ring,n_slots,steps", [(True, 4, 6), (False, 8, 6), (False, 4, 6)])
def test_cache_update_and_decode_match_reference(ring, n_slots, steps):
    rng = np.random.default_rng(n_slots + steps)
    jk = jv = jnp.zeros((B, n_slots, KV, D))
    jp = jnp.full((B, n_slots), -1, jnp.int32)
    tk, tv = torch.zeros((B, n_slots, KV, D)), torch.zeros((B, n_slots, KV, D))
    tp = torch.full((B, n_slots), -1, dtype=torch.int32)
    window = n_slots if ring else None
    for t in range(steps):
        kn = rng.standard_normal((B, 1, KV, D)).astype(np.float32)
        vn = rng.standard_normal((B, 1, KV, D)).astype(np.float32)
        jk, jv, jp = jattn.cache_update(jk, jv, jp, jnp.asarray(kn), jnp.asarray(vn),
                                        jnp.int32(t), ring=ring)
        tk, tv, tp = tattn.cache_update(tk, tv, tp, torch.from_numpy(kn),
                                        torch.from_numpy(vn), t, ring=ring)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
        want = jattn.decode_attention(jnp.asarray(q), jk, jv, jp, pos=jnp.int32(t),
                                      window=window)
        got = tattn.decode_attention(torch.from_numpy(q), tk, tv, tp, pos=t, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if ring:
        assert sorted(tp[0].tolist()) == list(range(steps - n_slots, steps))


def test_empty_cache_decode_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    jk = jnp.zeros((B, 4, KV, D))
    jp = jnp.full((B, 4), -1, jnp.int32)
    jk2, jv2, jp2 = jattn.cache_update(jk, jk, jp, jnp.asarray(q[:, :, :KV]),
                                       jnp.asarray(q[:, :, :KV]), jnp.int32(0), ring=False)
    want = jattn.decode_attention(jnp.asarray(q), jk2, jv2, jp2, pos=jnp.int32(0))
    tk = torch.zeros((B, 4, KV, D))
    tk2, tv2, tp2 = tattn.cache_update(tk, tk.clone(), torch.full((B, 4), -1, dtype=torch.int32),
                                       torch.from_numpy(q[:, :, :KV]),
                                       torch.from_numpy(q[:, :, :KV]), 0, ring=False)
    got = tattn.decode_attention(torch.from_numpy(q), tk2, tv2, tp2, pos=0)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_kvcache_empty_constructor():
    c = tattn.KVCache.empty(3, B, 8, KV, D)
    j = jattn.KVCache.empty(3, B, 8, KV, D)
    assert c.k.shape == c.v.shape == j.k.shape and c.n_slots == j.n_slots == 8
    assert c.k.dtype == torch.bfloat16 and c.positions.dtype == torch.int32
    assert (c.positions == -1).all() and (c.k == 0).all()


# ---------------------------------------------------------------------------
# The model: granite-8b-reduced, float32, the reference's weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    jcfg = dataclasses.replace(jget_config("granite-8b-reduced"), remat=False)
    tcfg = tget_config("granite-8b-reduced")
    jparams = jax.jit(lambda k: jtfm.init_model(jcfg, k, tp_size=1))(jax.random.PRNGKey(11))
    tparams = ttfm.params_from_jax(jax.device_get(jparams))
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (B, 12)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def test_prefill_matches_reference(granite):
    jcfg, tcfg, jparams, tparams, tokens = granite
    jlast, jstate = jtfm.prefill(jparams, jcfg, jnp.asarray(tokens))
    tlast, tstate = ttfm.prefill(tparams, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=MODEL_TOL, rtol=0)
    for got, want in zip(tstate.kv, jstate.kv):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=0)
    # the engine's prefill takes the chunked attention on both sides
    mesh = make_mesh((1, 1), ("data", "model"))
    jl2, _ = JServeEngine(jcfg, mesh).prefill_fn()(jparams, jnp.asarray(tokens))
    tl2, _ = tserve.ServeEngine(tcfg, "cpu").prefill_fn()(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=MODEL_TOL, rtol=0)
    np.testing.assert_allclose(tl2.numpy(), tlast.numpy(), atol=MODEL_TOL, rtol=0)


def _chain(lib, params, cfg, tokens, n_slots, window, step_pos, to_host):
    state = lib.init_decode_state(cfg, tokens.shape[0], n_slots, window=window)
    out = []
    for t in range(tokens.shape[1]):
        lg, state = lib.decode_step(params, cfg, tokens[:, t:t + 1], step_pos(t), state,
                                    window=window)
        out.append(to_host(lg))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_chain_matches_reference(granite, window):
    """Token-by-token decode against the reference's chain (window 5: the
    ring cache), and against the port's own windowed forward."""
    jcfg, tcfg, jparams, tparams, tokens = granite
    n_slots = window or tokens.shape[1]
    want = _chain(jtfm, jparams, jcfg, jnp.asarray(tokens), n_slots, window, jnp.int32,
                  np.asarray)
    got = _chain(ttfm, tparams, tcfg, torch.from_numpy(tokens), n_slots, window, int,
                 lambda x: x.numpy())
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=0)
    full = ttfm.forward(tparams, tcfg, torch.from_numpy(tokens), window=window)
    np.testing.assert_allclose(got, full.numpy(), atol=3e-3, rtol=1e-3)


def test_decode_window_and_shapes():
    eng = tserve.ServeEngine(tget_config("granite-8b-reduced"), "cpu")
    assert eng.decode_window(SHAPES["decode_32k"]) is None
    assert eng.decode_window(SHAPES["long_500k"]) == tserve.DEFAULT_WINDOW == 8192
    assert SHAPES["prefill_32k"].seq_len == 32_768
    if not torch.cuda.is_available():   # the engine runs on the card unless asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.ServeEngine(tget_config("granite-8b-reduced"))


def test_generate_greedy_equals_reference(granite):
    jcfg, tcfg, jparams, tparams, _ = granite
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab, (B, 5)).astype(np.int32)
    jeng = JServeEngine(jcfg, make_mesh((1, 1), ("data", "model")))
    want = np.asarray(jeng.generate(jparams, jnp.asarray(prompts), n_new=6, max_len=16))
    teng = tserve.ServeEngine(tcfg, "cpu")
    got = teng.generate(tparams, torch.from_numpy(prompts), n_new=6, max_len=16)
    np.testing.assert_array_equal(got.numpy(), want)
    # sampling draws from an explicit generator: same seed, same tokens
    kw = dict(n_new=6, max_len=16, temperature=0.8)
    a = teng.generate(tparams, torch.from_numpy(prompts), generator=torch.Generator().manual_seed(2), **kw)
    b = teng.generate(tparams, torch.from_numpy(prompts), generator=torch.Generator().manual_seed(2), **kw)
    assert torch.equal(a, b) and ((a >= 0) & (a < tcfg.vocab)).all()


def test_serve_main_runs_on_cpu(capsys):
    out = tserve.main(["--new", "3", "--batch", "2", "--prompt-len", "4"], device="cpu")
    assert out["greedy"].shape == out["sampled"].shape == (2, 3)
    assert ((out["greedy"] >= 0) & (out["greedy"] < 512)).all()
    text = capsys.readouterr().out
    assert "arch=granite-8b-reduced (reduced)" in text and "greedy:" in text


def test_other_families_raise():
    """Every family of the reference builds its decode state; a family the
    reference does not have raises."""
    for family, field in (("ssm", "rwkv"), ("hybrid", "hybrid")):
        arch = "rwkv6-1.6b" if family == "ssm" else "zamba2-7b"
        state = ttfm.init_decode_state(tget_config(arch + "-reduced"), 1, 4)
        assert getattr(state, field) is not None and state.kv is None
    cfg = dataclasses.replace(tget_config("granite-8b-reduced"), family="retrieval")
    with pytest.raises(ValueError, match="unknown model family"):
        ttfm.init_decode_state(cfg, 1, 4)
