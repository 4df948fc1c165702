"""The frozen yardstick: model FLOPs (the decoder module's count) worked
out by hand for both cells, held against the port's own matrix-multiply
FLOPs counted on the CPU, and the least bytes and kernel groups the
per-layer metrics read."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import manifest, reference, yardstick

MAN = manifest.load()


def _cell(name):
    wl = manifest.workload(MAN, name)
    return manifest.config(MAN, wl["config"]), manifest.traffic(wl["traffic"])


def _flops(name):
    cfg, tr = _cell(name)
    return reference.model(cfg).model_flops_per_step(cfg, nodes=cfg["nodes"],
                                                     per_node_batch=tr["per_node_batch"],
                                                     seq=tr["seq_len"])


def test_granite_flops_by_hand():
    # a layer: q, k, v, o 4096·128·(32 + 8 + 8 + 32) and the MLP 3·4096·14336;
    # 2 layers and the head 4096·49152; 4 nodes × 4 × 1024 tokens
    per_token = 2 * (4096 * 128 * 80 + 3 * 4096 * 14336) + 4096 * 49152
    assert per_token == 637_534_208
    dense = 6 * per_token * 4 * 4 * 1024
    attn = 3 * 4 * 128 * 32 * (1024 * 1025 // 2) * 4 * 4 * 2  # 4·Dh a pair, 2 layers
    assert _flops("granite8b-g4-b4x1024") == dense + attn
    assert round(_flops("granite8b-g4-b4x1024") / 1e13, 2) == 6.35


def test_phi_flops_by_hand():
    # attention as granite's; the router 4096·16 and 2 of 16 experts 3·4096·6400
    per_token = 4096 * 128 * 80 + 4096 * 16 + 2 * 3 * 4096 * 6400 + 4096 * 32064
    dense = 6 * per_token * 4 * 4 * 1024
    attn = 3 * 4 * 128 * 32 * (1024 * 1025 // 2) * 4 * 4
    assert _flops("phi35moe-g4-b4x1024") == dense + attn
    assert round(_flops("phi35moe-g4-b4x1024") / 1e13, 2) == 3.29


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_flops_against_the_ports_matmuls(moe):
    """One node's forward and backward through the port's loss with remat
    off: its matmul FLOPs equal the yardstick's with every (query, key)
    pair and, for experts, every capacity slot counted."""
    from perfbench.program import arch_config
    from repro_torch.models import transformer as tfm

    cfg = {"name": "tiny", "source": "x", "reference": "decoder",
           "family": "moe" if moe else "dense", "n_layers": 2,
           "d_model": 64, "n_heads": 4, "n_kv": 2, "d_head": 16, "d_ff": 96, "vocab": 128,
           "norm": "rmsnorm", "rope_theta": 1e4, "dtype": "float32", "remat": False}
    if moe:
        cfg.update(n_experts=4, top_k=2, capacity_factor=1.25, aux_loss_weight=0.01)
    b, s = 2, 32
    arch = arch_config(cfg)
    params = {k: v.requires_grad_() for k, v in
              tfm.init_model(arch, torch.Generator().manual_seed(0), "cpu").items()}
    tokens = torch.randint(0, 128, (b, s), dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        loss = tfm.loss_fn(params, arch, {"tokens": tokens, "targets": tokens})
        torch.autograd.grad(loss, list(params.values()))
    want = reference.model(cfg).model_flops_per_step(cfg, nodes=1, per_node_batch=b, seq=s,
                                                     causal=False)
    if moe:  # the experts run every capacity slot, not top_k of each token's
        cap = int(max(2 * b * s * 1.25 / 4, 4))
        want += 6 * 2 * 3 * 64 * 96 * (4 * cap - 2 * b * s)
    assert fc.get_total_flops() == want


def test_least_bytes_and_groups():
    assert yardstick.update_mix_least_bytes(4, 10, 10 * 2) == 4 * 10 * 14
    assert yardstick.probe_least_bytes(4, 10 * 2, 3) == 4 * 10 * 2 + 4 * 3 * 4
    assert yardstick.least_seconds(3.35e12) == pytest.approx(1.0)
    assert yardstick.kernel_group(
        "void (anonymous namespace)::program_update_kernel<__nv_bfloat16, false, true>") \
        == "update_mix"
    assert yardstick.kernel_group("void partial_kernel<float, true>(float const*)") == "probe"
    assert yardstick.kernel_group("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT") == "matmul"
    assert yardstick.kernel_group("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul"
    assert yardstick.kernel_group("void at::native::vectorized_elementwise_kernel<4>") == "other"


def test_state_of_the_cells():
    for name, want in (("granite-8b-x2-g4", 838_881_280), ("phi3.5-moe-x1-g4", 1_562_980_352)):
        cfg = manifest.config(MAN, name)
        assert sum(reference.leaf_sizes(cfg)) == want
