"""Zamba2-7B's cell (``zamba2-7b-g4-b4x1024``) on the CPU: the tiny cell
through ``run_cell`` reads ``correct``, each fault a run must catch is
caught, the program's leaves and dtypes are the reference module's table,
and at the published widths the parameters and the model FLOPs are the
values worked out by hand."""
import json

import pytest
import torch

from perfbench import manifest, program, reference
from perfbench.cell import run_cell

CELL = "zamba2-7b-g4-b4x1024"
CONFIG = "zamba2-7b-x6-g4"


def _cfg(root=manifest.ROOT) -> dict:
    return manifest.config(manifest.load(root), CONFIG, root)


class _Broken:
    """The trainer with its timed path broken underneath the harness."""

    def __init__(self, trainer, fault):
        self._t, self._fault = trainer, fault
        if fault == "no_mix":
            trainer._program_at = lambda step, epoch: None

    def __getattr__(self, name):
        return getattr(self._t, name)

    def train_step(self, state, batch, lr, **kw):
        if self._fault == "unchanged":
            _, loss, norms = self._t.train_step(state.clone(), batch, lr, **kw)
            return state, loss, norms
        if self._fault == "half_batch":
            half = batch["tokens"].shape[1] // 2
            batch = {k: v[:, :half] for k, v in batch.items()}
        state, loss, norms = self._t.train_step(state, batch, lr, **kw)
        if self._fault == "probe_shift":
            norms = torch.roll(norms, 1, dims=1)
        return state, loss, norms


def test_the_tiny_cell_is_correct(tiny_root):
    out = run_cell(CELL, 2**31 + 77, 0.05, False, root=tiny_root, device="cpu",
                   log=lambda _: None)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"tokens_per_s", "step_ms_p90", "setup_s"}   # no card


@pytest.mark.parametrize("fault", reference.FAULTS)
def test_a_broken_step_is_caught(tiny_root, fault):
    out = run_cell(CELL, 2**31 + 78, 0.05, False, root=tiny_root, device="cpu",
                   fault=lambda t: _Broken(t, fault), log=lambda _: None)
    assert out["correct"] is False


def test_the_programs_leaves_are_the_table(tiny_bf16_root):
    """In bfloat16 the state holds two dtypes: ``a_log`` and ``d_skip``
    float32, every other leaf bfloat16, so the flat state is float32."""
    cfg = _cfg(tiny_bf16_root)
    weights = reference.draw_weights(cfg, 3, "cpu", root=tiny_bf16_root)
    traffic = manifest.traffic("d_ring-b4x1024", tiny_bf16_root)
    trainer, state = program.build(cfg, traffic, weights, "cpu", tiny_bf16_root)
    layout = trainer.layout
    want = [(k, tuple(shape), dt) for k, shape, _, dt in reference.leaves(cfg, tiny_bf16_root)]
    assert list(zip(layout.names, layout.shapes, layout.dtypes)) == want
    f32 = {k for k, _, dt in zip(layout.names, layout.shapes, layout.dtypes)
           if dt == torch.float32}
    assert f32 == {"mixers.a_log", "mixers.d_skip"}
    assert layout.mixed and state.theta.dtype == torch.float32


def test_published_widths_by_hand():
    cfg = _cfg()
    mod = reference.model(cfg)
    sizes = dict(zip((k for k, *_ in reference.leaves(cfg)), reference.leaf_sizes(cfg)))
    mixer = 3584 * (2 * 7168 + 2 * 2 * 64 + 112) + (7168 + 2 * 2 * 64) * (4 + 1) \
        + 3 * 112 + 7168 + 7168 * 3584 + 3584
    assert mixer == 78_437_456
    block = 7168 + 3 * 7168 * 7168 + 7168 * 3584 + 3584 + 3 * 3584 * 14336
    assert block == 333_982_208
    assert sum(v for k, v in sizes.items() if k.startswith("mixers.")) == 6 * mixer
    assert sum(v for k, v in sizes.items() if k.startswith("shared_blocks.")) == block
    assert sizes["hybrid.adapter_a"] + sizes["hybrid.adapter_b"] == 4_128_768
    assert sizes["hybrid.linear"] == 3584 * 3584
    assert sum(sizes.values()) == 1_050_960_352
    assert reference.param_bytes(cfg) == 2 * 1_050_960_352 + 2 * 6 * 112 * 2

    # a token's matrix products: 6 mixers (W_in 3584 × 14,704, W_out 7168 ×
    # 3584), one shared-block use (q, k, v 7168 × 7168, o 7168 × 3584, the
    # MLP 3 × 3584 × 14,336, the adapter 128 × (3584 + 28,672), the linear
    # 3584²) and the head 3584 × 32,000
    per_token = 6 * (3584 * 14704 + 7168 * 3584) \
        + 3 * 7168 * 7168 + 7168 * 3584 + 3 * 3584 * 14336 + 128 * (3584 + 28672) \
        + 3584 * 3584 + 3584 * 32000
    assert per_token == mod.matmul_params_per_token(cfg) == 935_968_768
    seqs, seq = 4 * 4, 1024
    attn = 3 * 4 * 224 * 32 * (1024 * 1025 // 2) * seqs          # one hybrid layer
    pairs = 4 * (256 * 257 // 2)                                  # 4 chunks of 256
    ssd = 2 * pairs * (2 * 64 + 112 * 64) + 2 * 2 * seq * 112 * 64 * 64
    assert ssd == 3_799_121_920
    want = 6 * per_token * seqs * seq + attn + 3 * ssd * seqs * 6
    assert mod.model_flops_per_step(cfg, nodes=4, per_node_batch=4, seq=seq) == want
    assert round(want / 1e12, 2) == 93.83


@pytest.mark.parametrize("keys", [{"use_shared_attention_adapter": True},
                                  {"time_step_limit": [0.0, 1.0]}, {"hidden_act": "silu"},
                                  {"mamba_headdim": 32}, {"vocab": 32064},
                                  {"hybrid_layer_ids": [4]}],
                         ids=lambda k: next(iter(k)))
def test_the_reference_refuses_what_it_does_not_compute(keys):
    cfg = _cfg()
    assert program.arch_config(cfg).hybrid_layer_ids == (5,)
    with pytest.raises(ValueError, match="zamba2 reference"):
        program.arch_config({**cfg, **keys})


def test_the_configuration_states_its_cut():
    cfg = _cfg()
    entry = manifest._by_name(manifest.load()["configs"], CONFIG, "configuration")
    assert set(entry["reduced"]) == set(cfg["published"])
    assert cfg["published"]["num_hidden_layers"] == 81
    assert cfg["published"]["hybrid_layer_ids"][2] == 17
    assert cfg["layers_block_type"] == ["mamba"] * 5 + ["hybrid"]
    assert json.dumps(cfg["state_bytes_per_parameter"]) == \
        '{"theta": 4, "gradient": 4, "momentum": 4}'
