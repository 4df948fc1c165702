"""Port parity: the model zoo against ``repro.models.transformer``.

Every architecture of the reference registry, full and ``-reduced``: the
config's fields equal the reference's, and the leaves of ``model_defs``
(names, shapes, dtypes) equal ``jax.tree.leaves(model_defs(cfg, 1))``.
For every reduced architecture the reference's weights are carried across
with ``params_from_jax`` and the same numpy batch (seeded; a VLM's with
patch embeddings) goes through both packages in float32:

* the loss within 5e-5, and every gradient leaf within 5e-5; for the
  RWKV6 and Mamba2 families (ssm, hybrid), plus twice the reference's own
  float32 rounding of that leaf, measured against the reference run in
  float64 (``jax``'s x64 mode).  Those families normalize heads whose
  variance can sit near the norm's epsilon, where float32 gradients stray
  from float64 ones by up to ~2e-2.  The bar comes from the reference
  alone, so a precision fault in the port cannot widen it; the port's
  float64 run is held to the reference's within the same bar (both keep
  the recurrences and group norms in float32, as the reference does);
* the prefill logits and a chain of decode steps within 1e-5 (plus, for
  ssm and hybrid, twice the reference's prefill rounding);
* decode against forward at the reference's bar (atol 3e-3, rtol 1e-3,
  capacity factor 16 for MoE, as ``tests/test_decode_equivalence.py``);
* greedy generation gives the reference's tokens; a VLM prompt with
  patches generates the tokens a forward-pass oracle picks.

A VLM's loss without patches raises in the port, and fails in the
reference too (it slices off n_patches logits that were never prepended).
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES, get_config as jget_config  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.common import ParamDef as JParamDef  # noqa: E402
from repro_torch.configs.base import PORT_FIELDS  # noqa: E402
from repro_torch.configs import ARCH_NAMES as TARCH_NAMES  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

torch.set_num_threads(1)

B, S = 2, 16
TOL = 5e-5
DECODE_STEPS = 4


def _flat_np(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _x64():
    """jax's float64 mode for the block (its context manager by version)."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64

    return enable_x64()


def _torch_dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, port cfg, reference params, numpy batch), remat off."""
    jcfg = dataclasses.replace(jget_config(arch + "-reduced"), remat=False)
    tcfg = dataclasses.replace(tget_config(arch + "-reduced"), remat=False)
    jparams = jax.device_get(jax.jit(lambda k: jtfm.init_model(jcfg, k, tp_size=1))(
        jax.random.PRNGKey(3)))
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
             "targets": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.input_kind == "vlm":
        batch["patch_embeds"] = (0.1 * rng.standard_normal(
            (B, jcfg.n_patches, jcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, jparams, batch


def _ref_grads(jcfg, jparams, batch, dtype=jnp.float32):
    cfg = dataclasses.replace(jcfg, dtype=dtype)
    params = jax.tree.map(lambda x: jnp.asarray(x, dtype), jparams)
    jb = {k: jnp.asarray(v, dtype) if v.dtype == np.float32 else jnp.asarray(v)
          for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jtfm.loss_fn(p, cfg, jb)))(params)
    return float(loss), {k: v.astype(np.float64) for k, v in
                         _flat_np(jax.device_get(grads)).items()}


def _port_grads(tcfg, jparams, batch, dtype=torch.float32):
    cfg = dataclasses.replace(tcfg, dtype=dtype)
    params = {k: v.to(dtype).requires_grad_()
              for k, v in ttfm.params_from_jax(jparams).items()}
    tb = {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v)
          for k, v in batch.items()}
    loss = ttfm.loss_fn(params, cfg, tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {k: g.double().numpy() for k, g in zip(params, grads)}


# ---------------------------------------------------------------------------
# Registry and layout
# ---------------------------------------------------------------------------

def test_registry_holds_the_reference_archs():
    assert TARCH_NAMES == ARCH_NAMES
    with pytest.raises(ValueError, match="unknown arch"):
        tget_config("gpt-5")


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_leaves_match_reference(arch, reduced):
    name = arch + ("-reduced" if reduced else "")
    jcfg, tcfg = jget_config(name), tget_config(name)
    # the port's own fields (Zamba2's published block) follow the
    # reference's, each at its default (off) in every registered config
    assert [f.name for f in dataclasses.fields(tcfg)] == [
        f.name for f in dataclasses.fields(jcfg)] + list(PORT_FIELDS)
    defaults = {f.name: f.default for f in dataclasses.fields(tcfg)}
    assert all(getattr(tcfg, k) == defaults[k] for k in PORT_FIELDS)
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert _torch_dtype_name(tcfg.dtype) == jnp.dtype(jcfg.dtype).name
    jdefs = jtfm.model_defs(jcfg, 1)
    leaves = jax.tree.leaves(jdefs, is_leaf=lambda x: isinstance(x, JParamDef))
    paths = [".".join(str(getattr(k, "key", k)) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(
                 jdefs, is_leaf=lambda x: isinstance(x, JParamDef))[0]]
    tdefs = ttfm.model_defs(tcfg)
    assert list(tdefs) == paths
    for (name_, d), jd in zip(tdefs.items(), leaves):
        assert d.shape == jd.shape, name_
        assert _torch_dtype_name(d.dtype) == jnp.dtype(jd.dtype).name, name_


def test_head_padding_is_a_no_op_at_one_card():
    """No padding at a tensor-parallel size of 1; at 16 the padded configs
    pad as the reference's ``attn_dims`` does (it raised before tensor
    parallelism was ported)."""
    assert tattn.head_padding(40, 8, 1) == (40, 8, 5)
    assert tattn.head_padding(36, 4, 1) == (36, 4, 9)
    assert tattn.head_padding(24, 24, 1) == (24, 24, 1)
    for arch in ("qwen2.5-14b", "starcoder2-7b", "musicgen-medium"):
        cfg = tget_config(arch)
        assert cfg.pad_heads and ttfm.attn_dims(cfg) == (cfg.n_heads, cfg.n_kv)
        assert ttfm.attn_dims(cfg, 16) == jtfm.attn_dims(jget_config(arch), 16)
    assert ttfm.attn_dims(tget_config("qwen2.5-14b"), 16) == (48, 8)


def test_unknown_family_and_manual_ep_raise():
    """An unknown family raises; ``moe_impl="manual_ep"`` builds (it raised
    before expert parallelism was ported) and its loss and gradients on one
    card are the gather path's within the zoo's bar."""
    cfg = tget_config("granite-8b-reduced")
    with pytest.raises(ValueError, match="unknown model family"):
        ttfm.model_defs(dataclasses.replace(cfg, family="diffusion"))
    jcfg, tcfg, jparams, batch = _model("phi3.5-moe-42b-a6.6b")
    loss, grads = _port_grads(tcfg, jparams, batch)
    ep_loss, ep_grads = _port_grads(dataclasses.replace(tcfg, moe_impl="manual_ep"),
                                    jparams, batch)
    assert abs(ep_loss - loss) < TOL
    for k in grads:
        np.testing.assert_allclose(ep_grads[k], grads[k], rtol=0, atol=TOL, err_msg=k)


# ---------------------------------------------------------------------------
# Loss, gradients, prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg, jparams, batch = _model(arch)
    jloss, jg = _ref_grads(jcfg, jparams, batch)
    tloss, tg = _port_grads(tcfg, jparams, batch)
    assert abs(tloss - jloss) <= TOL, (tloss, jloss)
    assert list(tg) == list(jg)
    rounding = {k: 0.0 for k in jg}
    if tcfg.family in ("ssm", "hybrid"):
        # the reference's own float32 rounding, twice: the port's side
        # may not widen its own bar
        with _x64():
            jloss64, jg64 = _ref_grads(jcfg, jparams, batch, jnp.float64)
        tloss64, tg64 = _port_grads(tcfg, jparams, batch, torch.float64)
        rounding = {k: 2 * np.abs(jg[k] - jg64[k]).max() for k in jg}
        # both float64 runs keep the recurrences and group norms in float32
        # (as the reference does), so they too agree only within that bar
        assert abs(tloss64 - jloss64) <= TOL, (tloss64, jloss64)
        for k in jg:
            err64 = np.abs(tg64[k] - jg64[k]).max()
            assert err64 <= TOL + rounding[k], (k, err64, rounding[k])
    for k in jg:
        err = np.abs(tg[k] - jg[k]).max()
        assert err <= TOL + rounding[k], (k, err, rounding[k])


def _decode_chain(lib, params, cfg, tokens, state, n):
    out = []
    for t in range(n):
        tok = tokens[:, t:t + 1]
        if lib is ttfm:
            lg, state = lib.decode_step(params, cfg, torch.from_numpy(tok), t, state)
            out.append(lg.numpy())
        else:
            lg, state = lib.decode_step(params, cfg, jnp.asarray(tok), jnp.int32(t), state)
            out.append(np.asarray(lg))
    return np.stack(out, axis=1)


def _ref_serving(jcfg, jparams, batch, dtype=jnp.float32):
    """The reference's prefill last logits and (float32 only: its cache
    index arithmetic mixes int32 and int64 under x64) DECODE_STEPS decode
    logits."""
    cfg = dataclasses.replace(jcfg, dtype=dtype)
    params = jax.tree.map(lambda x: jnp.asarray(x, dtype), jparams)
    patches = batch.get("patch_embeds")
    last, _ = jtfm.prefill(params, cfg, jnp.asarray(batch["tokens"]),
                           patch_embeds=None if patches is None else jnp.asarray(patches, dtype))
    if dtype != jnp.float32:
        return np.asarray(last, np.float64), None
    chain = _decode_chain(jtfm, params, cfg, batch["tokens"],
                          jtfm.init_decode_state(cfg, B, S), DECODE_STEPS)
    return np.asarray(last, np.float64), chain.astype(np.float64)


def _port_serving(tcfg, jparams, batch, dtype=torch.float32):
    """The port's prefill (last logits, state) and decode logits."""
    cfg = dataclasses.replace(tcfg, dtype=dtype)
    params = {k: v.to(dtype) for k, v in ttfm.params_from_jax(jparams).items()}
    patches = batch.get("patch_embeds")
    with torch.no_grad():
        last, state = ttfm.prefill(params, cfg, torch.from_numpy(batch["tokens"]),
                                   patch_embeds=None if patches is None
                                   else torch.from_numpy(patches).to(dtype))
        chain = _decode_chain(ttfm, params, cfg, batch["tokens"],
                              ttfm.init_decode_state(cfg, B, S), DECODE_STEPS)
    return last.double().numpy(), chain.astype(np.float64), state


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_and_decode_match_reference(arch):
    """Within 1e-5, plus (ssm, hybrid) twice the reference's own float32
    rounding of its prefill logits against its float64 run, as for the
    gradients; the port's float64 prefill is held to the reference's
    float64 one within the same bar."""
    jcfg, tcfg, jparams, batch = _model(arch)
    jlast, jchain = _ref_serving(jcfg, jparams, batch)
    tlast, tchain, tstate = _port_serving(tcfg, jparams, batch)
    rounding = 0.0
    if tcfg.family in ("ssm", "hybrid"):
        with _x64():
            jlast64, _ = _ref_serving(jcfg, jparams, batch, jnp.float64)
        tlast64, _, _ = _port_serving(tcfg, jparams, batch, torch.float64)
        rounding = 2 * np.abs(jlast - jlast64).max()
        np.testing.assert_allclose(tlast64, jlast64, atol=1e-5 + rounding, rtol=0)
    np.testing.assert_allclose(tlast, jlast, atol=1e-5 + rounding, rtol=0)
    np.testing.assert_allclose(tchain, jchain, atol=1e-5 + rounding, rtol=0)
    n_prompt = S + (tcfg.n_patches if "patch_embeds" in batch else 0)
    if tcfg.family == "ssm":
        assert tstate.rwkv.wkv.shape[:2] == (tcfg.n_layers, B)
    elif tcfg.family == "hybrid":
        k = tstate.hybrid["attn_cache"][0]
        assert k.shape[:3] == (tcfg.n_layers // tcfg.attn_every, B, n_prompt)
        assert tstate.hybrid["mamba"].h.dtype == torch.float32
    else:
        assert tstate.kv[0].shape[:3] == (tcfg.n_layers, B, n_prompt)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_matches_forward(arch):
    """Token-by-token decode == the full causal forward, the reference's
    bar; MoE at capacity factor 16 (a full sequence drops tokens at the
    capacity limit, one token never does)."""
    cfg = tget_config(arch + "-reduced")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = ttfm.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens = torch.randint(0, cfg.vocab, (B, 12), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full = ttfm.forward(params, cfg, tokens)
        state = ttfm.init_decode_state(cfg, B, 12)
        dec = torch.stack([ttfm.decode_step(params, cfg, tokens[:, t:t + 1], t, state)[0]
                           for t in range(12)], dim=1)
    torch.testing.assert_close(dec, full, atol=3e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_remat_is_bit_for_bit_for_the_recurrent_blocks(arch):
    base = tget_config(arch + "-reduced")
    tokens = torch.randint(0, base.vocab, (B, S), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "targets": tokens}
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        params = {k: v.requires_grad_() for k, v in
                  ttfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu").items()}
        grads[remat] = torch.autograd.grad(ttfm.loss_fn(params, cfg, batch),
                                           list(params.values()))
    assert all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))


# ---------------------------------------------------------------------------
# The VLM path
# ---------------------------------------------------------------------------

def test_vlm_loss_needs_patches_in_both_packages():
    jcfg, tcfg, jparams, batch = _model("internvl2-2b")
    text = {k: v for k, v in batch.items() if k != "patch_embeds"}
    with pytest.raises(ValueError, match="patch_embeds"):
        ttfm.loss_fn(ttfm.params_from_jax(jparams), tcfg,
                     {k: torch.from_numpy(v) for k, v in text.items()})
    with pytest.raises((TypeError, ValueError)):
        jtfm.loss_fn(jparams, jcfg, {k: jnp.asarray(v) for k, v in text.items()})
    # text-only serving needs no patches, in both
    jlogits, _, _ = jtfm.forward(jparams, jcfg, jnp.asarray(text["tokens"]))
    with torch.no_grad():
        tlogits = ttfm.forward(ttfm.params_from_jax(jparams), tcfg,
                               torch.from_numpy(text["tokens"]))
    assert tlogits.shape == (B, S, tcfg.vocab)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "zamba2-7b",
                                  "internvl2-2b"])
def test_generate_greedy_equals_reference(arch):
    jcfg, tcfg, jparams, _ = _model(arch)
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab, (B, 5)).astype(np.int32)
    jeng = JServeEngine(jcfg, make_mesh((1, 1), ("data", "model")))
    want = np.asarray(jeng.generate(jparams, jnp.asarray(prompts), n_new=6, max_len=16))
    teng = tserve.ServeEngine(tcfg, "cpu")
    got = teng.generate(ttfm.params_from_jax(jparams), torch.from_numpy(prompts), n_new=6,
                        max_len=16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vlm_generate_with_patches_follows_the_forward_oracle():
    """With patches, decoding continues after them at position n_patches +
    S0: each greedy token is the argmax of the forward pass over the
    patches, the prompt and the tokens so far."""
    _, tcfg, jparams, batch = _model("internvl2-2b")
    params = ttfm.params_from_jax(jparams)
    prompts = torch.from_numpy(batch["tokens"][:, :6])
    patches = torch.from_numpy(batch["patch_embeds"])
    eng = tserve.ServeEngine(tcfg, "cpu")
    got = eng.generate(params, prompts, n_new=5, patch_embeds=patches)
    seq = prompts
    with torch.no_grad():
        for _ in range(5):
            logits = ttfm.forward(params, tcfg, seq, patch_embeds=patches)
            seq = torch.cat([seq, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    assert torch.equal(got, seq[:, prompts.shape[1]:])
    with torch.no_grad():
        last, state = eng.prefill_fn()(params, prompts, patches)
    assert state.kv[0].shape[2] == tcfg.n_patches + prompts.shape[1]
    torch.testing.assert_close(last, ttfm.forward(params, tcfg, prompts,
                                                  patch_embeds=patches)[:, -1])


def test_context_manager_for_x64_restores_float32():
    with _x64():
        assert jnp.ones(2, jnp.float64).dtype == jnp.float64
    with contextlib.suppress(UserWarning):
        assert jnp.asarray(np.ones(2)).dtype == jnp.float32
