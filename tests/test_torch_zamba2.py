"""Zamba2's published hybrid block in the port (``hybrid_layer_ids``)
against the benchmark's plain reference (``perfbench/references/zamba2.py``)
on seeded random weights on the CPU, and the reference against
``transformers``' ``Zamba2ForCausalLM``.

The tiny size is the reference module's ``TINY``: 4 layers, 3 of them
hybrid over 2 shared blocks (uses 0 and 2 read block 0, use 1 block 1,
each use its own adapter and linear), 2 SSD heads of 64 in 2 groups of B
and C, a chunk of 8.

Tolerances, each with its reason:

* float64: 1e-10.  The two sides compute the same mathematics in other
  orders (the program's scan by chunks, the reference's over the whole
  sequence); at these sizes they read at most 5e-13 apart (seeds 1-4).
* float32: the loss 1e-6 (readings ≤ 1e-7), the logits 1e-4 of their
  largest (readings ≤ 1.1e-5); every
  leaf's gradient 1e-3 relative.  The program sums each chunk's decay
  exponents as differences of cumulative sums, the reference term by term
  for each pair, and a leaf read through exp(Σ dt·A) (``a_log``,
  ``dt_bias``, ``w_dt``), or behind it, carries that float32 rounding:
  up to 1.1e-4 (seeds 1-4), so 1e-3 leaves nine times the room.
* A bfloat16 forward of the program reads gradient gaps of 0.37 and more
  (seeds 1-4): it fails the float32 tolerances, as the test below checks.
"""
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import program, reference  # noqa: E402
from perfbench.references import zamba2 as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import recurrence as rec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.telemetry import MetricsRecorder  # noqa: E402

CONFIG = ROOT / "perfbench" / "configs" / "zamba2-7b-x6-g4.json"
TOL = {torch.float64: {"loss": 1e-12, "logits": 1e-10, "grad": 1e-10},
       torch.float32: {"loss": 1e-6, "logits": 1e-4, "grad": 1e-3}}


def _cfg(**keys) -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg.update(ref.tiny(cfg), **keys)
    return cfg


def _arch(cfg, dtype):
    return dataclasses.replace(program.arch_config({**cfg, "dtype": "float32"}), dtype=dtype)


def _weights(cfg, seed, dtype):
    """The reference's draw at ``seed``; every leaf in ``dtype`` except the
    float32 ``a_log`` and ``d_skip`` below float64."""
    w = reference.draw_weights(cfg, seed, "cpu", dtype=torch.float32)
    keep = lambda k: k.endswith(("a_log", "d_skip")) and dtype != torch.float64
    return {k: v if keep(k) else v.to(dtype) for k, v in w.items()}


def _targets(tokens):
    """Next-token targets, the last position left out (−1)."""
    return torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)


def _program(cfg, weights, tokens, dtype):
    """The port's logits, loss and gradients (each leaf's) on ``weights``."""
    arch = _arch(cfg, dtype)
    p = {k: v.clone().requires_grad_() for k, v in weights.items()}
    logits = tfm.forward(p, arch, tokens)
    loss = tfm.cross_entropy(logits, _targets(tokens))
    return logits.detach(), loss.detach(), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def _reference(cfg, weights, tokens, dtype):
    """The reference's, in ``dtype`` (float32 or float64)."""
    q = {k: v.detach().to(dtype).clone().requires_grad_() for k, v in weights.items()}
    logits = ref.forward(q, cfg, tokens)
    loss = ref.loss_fn(q, cfg, tokens, _targets(tokens))
    return logits.detach(), loss.detach(), dict(zip(q, torch.autograd.grad(loss, list(q.values()))))


def _gaps(prog, want) -> dict:
    (lp, sp, gp), (lr, sr, gr) = prog, want
    rel = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    return {"loss": abs(float(sp) - float(sr)) / abs(float(sr)),
            "logits": float((lp.double() - lr.double()).abs().max() / lr.double().abs().max()),
            "grad": {k: rel(gp[k], gr[k]) for k in gr}}


def _within(gaps, tol) -> bool:
    return gaps["loss"] <= tol["loss"] and gaps["logits"] <= tol["logits"] \
        and max(gaps["grad"].values()) <= tol["grad"]


@pytest.mark.parametrize("seq", [16, 13], ids=["whole-chunks", "part-chunk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_port_matches_the_reference(dtype, seq):
    """Logits, loss and every leaf's gradient, on a sequence of whole
    chunks (16 = 2 × 8) and on one that ends inside a chunk (13)."""
    cfg = _cfg()
    for seed in (1, 2):
        weights = _weights(cfg, seed, dtype)
        tokens = torch.randint(0, cfg["vocab"], (2, seq),
                               generator=torch.Generator().manual_seed(seed))
        gaps = _gaps(_program(cfg, weights, tokens, dtype),
                     _reference(cfg, weights, tokens, dtype))
        assert _within(gaps, TOL[dtype]), gaps
        assert all(v > 0 for v in _reference(cfg, weights, tokens, dtype)[2]["hybrid.linear"]
                   .flatten(1).norm(dim=1))   # every use's own linear moves


def test_a_bfloat16_forward_fails_the_float32_tolerances():
    cfg = _cfg()
    weights = _weights(cfg, 3, torch.bfloat16)
    tokens = torch.randint(0, cfg["vocab"], (2, 16), generator=torch.Generator().manual_seed(3))
    gaps = _gaps(_program(cfg, weights, tokens, torch.bfloat16),
                 _reference(cfg, weights, tokens, torch.float32))
    assert not _within(gaps, TOL[torch.float32]), gaps


def test_two_groups_read_their_own_b_and_c():
    """Head j of 4 reads group j // 2: the grouped scan equals the
    one-group scan of each half of the heads with its own group's B and C,
    and its step-by-step oracle."""
    g = torch.Generator().manual_seed(5)
    b, l, h, p, n = 2, 11, 4, 3, 5
    x = torch.randn(b, l, h, p, generator=g, dtype=torch.float64)
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=g, dtype=torch.float64))
    a_log = torch.randn(h, generator=g, dtype=torch.float64) * 0.3
    bg, cg = (torch.randn(b, l, 2, n, generator=g, dtype=torch.float64) for _ in range(2))
    d_skip = torch.randn(h, generator=g, dtype=torch.float64)
    h0 = torch.randn(b, h, p, n, generator=g, dtype=torch.float64) * 0.1
    y, hf = rec.ssd_chunked(x, dt, a_log, bg, cg, d_skip, h0, chunk=4)
    for grp, heads in enumerate((slice(0, 2), slice(2, 4))):
        yg, hg = rec.ssd_chunked(x[:, :, heads], dt[:, :, heads], a_log[heads], bg[:, :, grp],
                                 cg[:, :, grp], d_skip[heads], h0[:, heads], chunk=4)
        torch.testing.assert_close(y[:, :, heads], yg, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(hf[:, heads], hg, rtol=1e-12, atol=1e-12)
        ys, hs = rec.ssd_scan_reference(x[:, :, heads], dt[:, :, heads], a_log[heads],
                                        bg[:, :, grp], cg[:, :, grp], d_skip[heads],
                                        h0[:, heads])
        torch.testing.assert_close(y[:, :, heads], ys, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(hf[:, heads], hs, rtol=1e-10, atol=1e-10)


def test_a_shared_block_gradient_sums_over_its_uses():
    """Block 0 runs at uses 0 and 2.  With three blocks, block 2 a copy of
    block 0 (each use its own), the loss is the same, and block 0's
    gradient of the shared model is the sum of blocks 0 and 2's."""
    cfg = _cfg()
    weights = _weights(cfg, 4, torch.float64)
    tokens = torch.randint(0, cfg["vocab"], (2, 16), generator=torch.Generator().manual_seed(4))
    _, loss, grads = _program(cfg, weights, tokens, torch.float64)
    untied = {k: torch.cat([v, v[:1]]) if k.startswith("shared_blocks.") else v
              for k, v in weights.items()}
    _, loss3, grads3 = _program({**cfg, "num_mem_blocks": 3}, untied, tokens, torch.float64)
    assert float(loss3) == pytest.approx(float(loss), rel=1e-14)
    for k in grads:
        if k.startswith("shared_blocks."):
            torch.testing.assert_close(grads[k][0], grads3[k][0] + grads3[k][2])
            torch.testing.assert_close(grads[k][1], grads3[k][1])
            assert float(grads3[k][2].norm()) > 0


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_spans_and_counts_of_a_step(remat):
    """Inside a device trace: a ``shared_block`` span a use and an ``ssd``
    span a mixer, under the step's span; the counts of a step are the
    chunks (layers × ⌈S / chunk⌉) and the uses, forward only: under remat
    the backward pass's recompute opens and counts nothing."""
    cfg = _cfg()
    arch = dataclasses.replace(_arch(cfg, torch.float32), remat=remat)
    weights = {k: v.requires_grad_() for k, v in _weights(cfg, 6, torch.float32).items()}
    tokens = torch.randint(0, cfg["vocab"], (2, 20), generator=torch.Generator().manual_seed(6))
    recorder = MetricsRecorder()
    recorder.configure(device="cpu")
    with recorder.device_trace() as records:
        for step in (3, 4):
            with recorder.span("train_step", step=step):
                loss = tfm.loss_fn(weights, arch, {"tokens": tokens, "targets": tokens})
                torch.autograd.grad(loss, list(weights.values()))
    names = [r["name"] for r in records if r["step"] == 3]
    assert names == ["train_step", "ssd", "shared_block", "ssd", "shared_block", "ssd",
                     "shared_block", "ssd"]
    assert {r["parent"] for r in records if r["name"] != "train_step"} == {"train_step"}
    assert records.counts == {"ssd_chunks": {3: 4 * 3, 4: 4 * 3},
                              "shared_block_uses": {3: 3, 4: 3}}
    # no trace open: nothing is recorded
    tfm.loss_fn(weights, arch, {"tokens": tokens, "targets": tokens})
    assert records.counts["ssd_chunks"] == {3: 12, 4: 12}


def test_serving_and_tensor_parallel_ranks_refuse_the_block():
    cfg = _arch(_cfg(), torch.float32)
    weights = tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    calls = {
        "prefill": lambda: tfm.prefill(weights, cfg, tokens),
        "decode_step": lambda: tfm.decode_step(weights, cfg, tokens[:, :1], 0,
                                               tfm.DecodeState()),
        "serving": lambda: tfm.init_decode_state(cfg, 1, 8),
        "a tensor-parallel rank": lambda: tfm.forward_full(weights, cfg, tokens, tp=object()),
    }
    for what, call in calls.items():
        with pytest.raises(NotImplementedError, match=f"hybrid_layer_ids.*{what}"):
            call()
    with pytest.raises(NotImplementedError, match="a tensor-parallel rank"):
        tfm.model_defs(cfg, 2)


# the option off: zamba2-7b-reduced's leaves (name, shape, dtype), frozen
# from the tree before the option came in (sha256)
OFF_LEAVES = "73af31f7d888ab7f242f8441b933459a813d8d0e12b42654fc356f873ada9bc2"


def test_with_the_option_off_the_hybrid_family_is_as_before():
    """zamba2-7b-reduced keeps its leaves, and its loss and every leaf's
    gradient are the JAX package's on the same weights: the loss within
    5e-5, each gradient within 5e-5 plus twice the JAX package's own
    float32 rounding (its float64 run against its float32 one), the bar
    of the zoo's parity tests, which the scans' other summation orders
    (the port's chunks all at once, the JAX package's in turn) keep to."""
    jax = pytest.importorskip("jax")
    import numpy as np
    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtfm

    cfg = get_config("zamba2-7b-reduced")
    assert not cfg.hybrid_layer_ids
    defs = tfm.model_defs(cfg)
    assert len(defs) == 38
    assert hashlib.sha256(repr([(k, d.shape, str(d.dtype)) for k, d in defs.items()])
                          .encode()).hexdigest() == OFF_LEAVES
    jcfg = dataclasses.replace(jget_config("zamba2-7b-reduced"), remat=False)
    jparams = jax.device_get(jtfm.init_model(jcfg, jax.random.PRNGKey(3), tp_size=1))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    batch = {"tokens": tokens, "targets": tokens}

    def jax_side(dtype):
        c = dataclasses.replace(jcfg, dtype=dtype)
        params = jax.tree.map(lambda x: x.astype(dtype), jparams)
        loss, g = jax.jit(jax.value_and_grad(lambda q: jtfm.loss_fn(q, c, batch)))(params)
        flat = {}

        def walk(tree, prefix=""):
            for k in sorted(tree):
                if isinstance(tree[k], dict):
                    walk(tree[k], f"{prefix}{k}.")
                else:
                    flat[f"{prefix}{k}"] = np.asarray(tree[k], dtype=np.float64)
        walk(jax.device_get(g))
        return float(loss), flat

    jloss, jg = jax_side(np.float32)
    if hasattr(jax, "enable_x64"):
        x64 = jax.enable_x64(True)
    else:
        from jax.experimental import enable_x64 as x64_of
        x64 = x64_of()
    with x64:
        _, jg64 = jax_side(np.float64)
    p = {k: v.requires_grad_() for k, v in tfm.params_from_jax(jparams).items()}
    loss = tfm.loss_fn(p, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    assert abs(float(loss.detach()) - jloss) <= 5e-5
    assert list(grads) == list(jg)
    for k, g in grads.items():
        err = np.abs(g.double().numpy() - jg[k]).max()
        assert err <= 5e-5 + 2 * np.abs(jg[k] - jg64[k]).max(), k


# ---------------------------------------------------------------------------
# the reference against transformers' Zamba2ForCausalLM
# ---------------------------------------------------------------------------

def _hf_model(cfg):
    """``Zamba2ForCausalLM`` of the tiny configuration, float32, eager
    attention, its own head (no tie)."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.Zamba2Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_hidden_layers=cfg["num_hidden_layers"], layers_block_type=cfg["layers_block_type"],
        mamba_d_state=cfg["mamba_d_state"], mamba_d_conv=cfg["mamba_d_conv"],
        mamba_expand=cfg["mamba_expand"], mamba_ngroups=cfg["mamba_ngroups"],
        n_mamba_heads=cfg["n_mamba_heads"], chunk_size=cfg["chunk_size"],
        intermediate_size=cfg["intermediate_size"], hidden_act=cfg["hidden_act"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"], num_mem_blocks=cfg["num_mem_blocks"],
        use_shared_attention_adapter=False, adapter_rank=cfg["adapter_rank"],
        use_mem_rope=True, rope_theta=cfg["rope_theta"], rms_norm_eps=cfg["rms_norm_eps"],
        time_step_min=cfg["time_step_min"], tie_word_embeddings=False, use_cache=False,
        attn_implementation="eager")
    return transformers.Zamba2ForCausalLM(hf).eval()


def _load_hf(model, cfg, p) -> int:
    """Copy the reference's leaves ``p`` into ``model``; returns how many of
    its parameters were written."""
    m = model.model
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    di = cfg["mamba_expand"] * d
    gn = cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    put = {}

    def set_(param, value):
        put[id(param)] = param
        with torch.no_grad():
            param.copy_(value.reshape(param.shape))

    set_(m.embed_tokens.weight, p["embed"])
    set_(model.lm_head.weight, p["head"].t())
    set_(m.final_layernorm.weight, p["final_norm.g"])
    hybrid = list(cfg["hybrid_layer_ids"])
    for l, layer in enumerate(m.layers):
        dec = layer.mamba_decoder if l in hybrid else layer
        mx = dec.mamba
        g = lambda name: p[f"mixers.{name}"][l]
        set_(dec.input_layernorm.weight, g("norm_g"))
        set_(mx.in_proj.weight, torch.cat([g("w_z"), g("w_x"), g("w_b"), g("w_c"), g("w_dt")],
                                          dim=1).t())
        set_(mx.conv1d.weight, g("conv_w").t()[:, None, :])
        set_(mx.conv1d.bias, g("conv_b"))
        set_(mx.dt_bias, g("dt_bias"))
        set_(mx.A_log, g("a_log"))
        set_(mx.D, g("d_skip"))
        set_(mx.norm.weight, g("gn_g"))
        set_(mx.out_proj.weight, g("w_out").t())
        if l in hybrid:
            k = hybrid.index(l)
            b = k % cfg["num_mem_blocks"]
            blk = layer.shared_transformer
            s = lambda name: p[f"shared_blocks.{name}"][b]
            set_(layer.linear.weight, p["hybrid.linear"][k].t())
            set_(blk.input_layernorm.weight, s("ln1.g"))
            set_(blk.pre_ff_layernorm.weight, s("ln2.g"))
            for w in "qkv":
                set_(getattr(blk.self_attn, f"{w}_proj").weight, s(f"w{w}").flatten(1).t())
            set_(blk.self_attn.o_proj.weight, s("wo").flatten(0, 1).t())
            ff = blk.feed_forward
            set_(ff.gate_up_proj.weight, torch.cat([s("ffn.w_gate"), s("ffn.w_up")], dim=1).t())
            set_(ff.down_proj.weight, s("ffn.w_down").t())
            adapter = ff.gate_up_proj_adapter_list[k]
            set_(adapter[0].weight, p["hybrid.adapter_a"][k].t())
            set_(adapter[1].weight, p["hybrid.adapter_b"][k].t())
    assert d and di and gn and f
    return len(put)


def test_the_reference_is_the_published_block():
    """Logits and loss of ``Zamba2ForCausalLM`` (``torch_forward``, the CPU
    path) on the reference's weights mapped into it, float32: 2 shared
    blocks used in turn with RoPE, the MLP's adapters, 2 groups.  The
    sequence (14) fits in one chunk (16): from the second chunk on, the CPU
    path's state passing sums over the target chunk where the source is
    meant (``modeling_zamba2.py:882``, ``.sum(dim=2)``), so it is not the
    recurrence there; the reference's scan across chunks is held to the
    plain recurrence below.  dt_bias is drawn in [-2, -1] and w_dt small,
    so dt ≥ softplus(-2.1) ≈ 0.11 and the CPU path's clamp at
    ``time_step_min`` (1e-3) does not bind.  Tolerance 1e-5 of the logits'
    scale: HF's RoPE tables are float32 whatever the model's dtype, and
    the two scans round differently; the readings are under 3e-6."""
    cfg = _cfg(chunk_size=16)
    model = _hf_model(cfg)
    p = reference.draw_weights(cfg, 7, "cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(8)
    p["mixers.dt_bias"] = -1.0 - torch.rand(p["mixers.dt_bias"].shape, generator=gen)
    p["mixers.w_dt"] = p["mixers.w_dt"] * 0.02
    written = _load_hf(model, cfg, p)
    assert written == len({id(q) for q in model.parameters()})
    tokens = torch.randint(0, cfg["vocab"], (2, 14), generator=gen)
    with torch.no_grad():
        out = model(input_ids=tokens.long(), labels=tokens.long())
        logits = ref.forward(p, cfg, tokens)
        loss = ref.loss_fn(p, cfg, tokens, _targets(tokens))
    scale = float(logits.abs().max())
    assert float((out.logits - logits).abs().max()) / scale < 1e-5
    assert abs(float(out.loss) - float(loss)) / float(loss) < 1e-5


def test_the_references_scan_is_the_recurrence():
    """The reference's full-sequence SSD against the recurrence written out
    step by step, h_t = exp(dt_t A) h_{t−1} + dt_t x_t B_tᵀ, y_t = h_t C_t +
    D x_t, head j on group j // 2, in float64 over 40 steps."""
    g = torch.Generator().manual_seed(9)
    b, l, h, p, n = 2, 40, 4, 3, 5
    x = torch.randn(b, l, h, p, generator=g, dtype=torch.float64)
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=g, dtype=torch.float64))
    a = -torch.exp(torch.randn(h, generator=g, dtype=torch.float64))
    bg, cg = (torch.randn(b, l, 2, n, generator=g, dtype=torch.float64) for _ in range(2))
    d_skip = torch.randn(h, generator=g, dtype=torch.float64)
    got = ref._ssd(x, dt, a, bg, cg, d_skip, torch.einsum)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    for t in range(l):
        for j in range(h):
            state[:, j] = torch.exp(dt[:, t, j] * a[j])[:, None, None] * state[:, j] \
                + dt[:, t, j, None, None] * x[:, t, j, :, None] * bg[:, t, j // 2, None, :]
            want = state[:, j] @ cg[:, t, j // 2, :, None]
            torch.testing.assert_close(got[:, t, j], want[..., 0] + d_skip[j] * x[:, t, j],
                                       rtol=1e-10, atol=1e-10)
