"""Port parity: serving on a mesh — ``ServeEngine(cfg, mesh=...)`` on a
(2 data × 2 model) world of 4 gloo ranks (B = 2, a row a data rank) and on
a (1 × 2) world (B = 1) on the CPU — against the reference's
``tfm.prefill``/``tfm.decode_step`` with ``init_decode_state(...,
tp_size=2)`` on one device.

Every case starts from the reference's ``init_model(cfg, key,
tp_size=2)`` weights (float32, heads padded at the model size of 2 where
the config pads), prompts of 8 tokens.  Checked per case and world: the
prefill's last-token logits, 8 ``decode_step`` logits (from an empty
state over the prompt's tokens; a VLM's after its prefill, the caches
grown) within 5e-5 (for the ssm and hybrid families plus twice the
reference's own float32 rounding of them against its float64 run, the
bar of ``test_torch_zoo.py``), and 4 greedy ``generate`` tokens equal to the
reference's (its prefill, then greedy decode steps against a state sized
at tp 2); each rank's decode state holds its share (its KV heads by
``cache_kv_heads``, its RWKV and Mamba2 heads).  Cases: dense
(granite-8b-reduced, 4/2 heads on "model"), the contraction fallback
(3/1 heads), padded heads (qwen2.5-14b-reduced 3/1 → (4, 1, 4)), padded
KV heads (``pad_kv``: (6, 2, 3)), MoE with manual EP (phi3.5-moe-reduced,
2 experts a rank; the reference runs its ``apply_moe``), rwkv6, zamba2,
and internvl2 with its patches.  The reference's own ``generate`` sizes
its state at tp 1 and cannot serve the padded-KV model; the port's can.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_tp_worker  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

TP, S, DEC, NEW, TOL = 2, 8, 8, 4, 5e-5
WORLDS = {"2x2": (2, 2, 2), "1x2": (1, 2, 1)}   # (data, model, batch)
HEADS31 = (("n_heads", 3), ("n_kv", 1), ("d_head", 64))
CASES = {
    "dense": ("granite-8b", ()),
    "contraction": ("granite-8b", HEADS31),
    "padded": ("qwen2.5-14b", HEADS31),
    "padded-kv": ("qwen2.5-14b", HEADS31 + (("pad_kv", True),)),
    "moe-manual_ep": ("phi3.5-moe-42b-a6.6b", (("moe_impl", "manual_ep"),)),
    "rwkv6": ("rwkv6-1.6b", ()),
    "zamba2": ("zamba2-7b", ()),
    "internvl2": ("internvl2-2b", ()),
}


def _jcfg(name):
    arch, replace = CASES[name]
    replace = dict(replace)
    if replace.get("moe_impl") == "manual_ep":
        replace["moe_impl"] = "gather"      # the reference's manual EP needs a mesh
    return dataclasses.replace(jget_config(arch + "-reduced"), dtype=jnp.float32,
                               remat=False, **replace)


@functools.lru_cache(maxsize=None)
def _init(name):
    cfg = _jcfg(name)
    return jax.device_get(jax.jit(lambda k: jtfm.init_model(cfg, k, tp_size=TP))(
        jax.random.PRNGKey(11)))


def _inputs(b):
    """(prompts (b, S), the VLM's patch embeddings (b, n_patches, D)): every
    reduced config has a vocabulary of 512."""
    rng = np.random.default_rng(3)
    vlm = _jcfg("internvl2")
    assert {_jcfg(name).vocab for name in CASES} == {512}
    prompts = rng.integers(0, 512, (2, S)).astype(np.int32)
    patches = rng.standard_normal((2, vlm.n_patches, vlm.d_model)).astype(np.float32)
    return prompts[:b], patches[:b]


def _grow(state, slots):
    """A reference state's caches grown to ``slots`` (empty: 0 and -1)."""
    def grow(kv):
        k, v, p = kv
        extra = slots - k.shape[2]
        pad = lambda x, fill: jnp.concatenate(
            [x, jnp.full(x.shape[:2] + (extra,) + x.shape[3:], fill, x.dtype)], axis=2)
        return pad(k, 0), pad(v, 0), pad(p, -1)

    if state.kv is not None:
        return state._replace(kv=grow(state.kv))
    if state.hybrid is not None and state.hybrid["attn_cache"] is not None:
        return state._replace(hybrid=dict(state.hybrid, attn_cache=grow(
            state.hybrid["attn_cache"])))
    return state


def _x64():
    """jax's float64 mode for the block (its context manager by version)."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64

    return enable_x64()


@functools.lru_cache(maxsize=None)
def _rounding(name, b):
    """The bar's rounding term: 0, or for the ssm and hybrid families twice
    the reference's own float32 rounding of its prefill logits against its
    float64 run, which ``test_torch_zoo.py`` takes for the decode chain too
    (the reference's decode step does not run under x64: its index
    arithmetic mixes int32 and int64)."""
    cfg = _jcfg(name)
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    last = _reference(name, b)[0]
    prompts, patches = _inputs(b)
    with _x64():
        cfg64 = dataclasses.replace(cfg, dtype=jnp.float64)
        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), _init(name))
        last64, _ = jtfm.prefill(params, cfg64, jnp.asarray(prompts))
        return 2 * float(np.abs(last - np.asarray(last64)).max())


@functools.lru_cache(maxsize=None)
def _reference(name, b):
    """The reference at batch ``b``: prefill's last logits, the decode
    chain's logits, greedy tokens (its state sized at tp 2)."""
    cfg = _jcfg(name)
    params = jax.tree.map(jnp.asarray, _init(name))
    prompts, patches = _inputs(b)
    toks = jnp.asarray(prompts)
    pe = jnp.asarray(patches) if cfg.input_kind == "vlm" else None
    prefill = jax.jit(lambda p, t, e: jtfm.prefill(p, cfg, t, patch_embeds=e))
    step = jax.jit(lambda p, t, pos, st: jtfm.decode_step(p, cfg, t, pos, st))
    last, st = prefill(params, toks, pe)
    n_p = cfg.n_patches if pe is not None else 0

    def fresh(slots):
        if pe is not None:
            return _grow(st, slots), n_p + S
        return jtfm.init_decode_state(cfg, b, slots, tp_size=TP), 0

    state, pos = fresh(n_p + S + DEC if pe is not None else DEC)
    chain = []
    for t in range(DEC):
        logits, state = step(params, toks[:, t:t + 1], jnp.int32(pos + t), state)
        chain.append(np.asarray(logits))
    state, pos = fresh(n_p + S + NEW)
    gen_last = last
    if pe is None:
        for t in range(S):
            gen_last, state = step(params, toks[:, t:t + 1], jnp.int32(t), state)
        pos = S
    out = []
    for i in range(NEW):
        tok = jnp.argmax(gen_last, axis=-1)[:, None]
        out.append(np.asarray(tok))
        gen_last, state = step(params, tok, jnp.int32(pos + i), state)
    return np.asarray(last), np.stack(chain), np.concatenate(out, axis=1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """world -> case -> the results of its ranks (rank i·m + j: shard j of
    replica i), each world spawned once."""
    params = {name: {k: v.numpy() for k, v in params_from_jax(_init(name)).items()}
              for name in CASES}
    out = {}
    for world, (data, model, b) in WORLDS.items():
        prompts, patches = _inputs(b)
        results = spawn_world(_torch_tp_worker.serve_cases, data * model,
                              (CASES, params, prompts, patches, DEC, NEW, data, model),
                              timeout=300, device="cpu",
                              workdir=tmp_path_factory.mktemp("world"))
        out[world] = {name: [r[name] for r in results] for name in CASES}
    return out


def _local_state_shapes(name, b, tp_rank):
    """The shapes of one rank's decode state after its prefill of b rows."""
    from repro_torch.configs import get_config as tget

    arch, replace = CASES[name]
    cfg = dataclasses.replace(tget(arch + "-reduced"), dtype=torch.float32, remat=False,
                              **dict(replace))
    slots = S + (cfg.n_patches if cfg.input_kind == "vlm" else 0)
    st = ttfm.init_decode_state(cfg, b, slots, device="meta", tp_size=TP, tp_rank=tp_rank)
    return [tuple(x.shape) for x in tree_leaves(st) if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("check", ["prefill", "decode_step", "generate"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_serving_matches_the_reference(worlds, world, case, check):
    data, model, b = WORLDS[world]
    per_rank = worlds[world][case]
    assert all(r["engine"] == (TP, True, data) for r in per_rank)
    last, chain, tokens = _reference(case, b)
    for r, res in enumerate(per_rank):
        if check == "prefill":
            assert res["prefill"].shape == last.shape
            assert np.abs(res["prefill"] - last).max() <= TOL + _rounding(case, b), r
            # this rank's decode state: its rows (all of them for a MoE
            # model), its heads
            rows = b // data if b % data == 0 and not _jcfg(case).n_experts else b
            assert res["state_shapes"] == _local_state_shapes(case, rows, r % model), r
        elif check == "decode_step":
            assert res["chain"].shape == chain.shape
            assert np.abs(res["chain"] - chain).max() <= TOL + _rounding(case, b), r
        else:
            assert np.array_equal(res["tokens"], tokens), (r, res["tokens"], tokens)


def test_reference_generate_at_tp1_cannot_serve_padded_kv_and_the_port_can(worlds):
    """The reference's ``ServeEngine.generate`` sizes its decode state at tp
    1 (``init_decode_state(cfg, b, max_len)``), which holds 1 KV head where
    the pad_kv model at tp 2 has 2: its first decode step fails.  The port's
    mesh engine sizes the state at the mesh's tp and gives the tokens of the
    reference's own prefill and decode steps at tp 2."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    engine = JServeEngine(_jcfg("padded-kv"), mesh)
    params = jax.tree.map(jnp.asarray, _init("padded-kv"))
    assert params["blocks"]["wk"].shape[2] == 2          # (L, d, kv_pad, dh)
    prompts, _ = _inputs(2)
    with pytest.raises(Exception):
        engine.generate(params, jnp.asarray(prompts), NEW)
    _, _, tokens = _reference("padded-kv", 2)
    for res in worlds["2x2"]["padded-kv"]:
        assert np.array_equal(res["tokens"], tokens)
