"""The frozen yardstick: the card's peaks, a step's model FLOPs from the
configuration's shapes, the least bytes of the update-and-mix and of the
probe, and the groups the device trace sorts kernels into by name.

Nothing here reads the program: a later change to the program cannot move
what a metric is measured against.

Model FLOPs count the work the model needs, not what the program
dispatches: 6 × the matrix-multiply parameters a token touches (the
attention projections, the MLP or the router and the top-k experts, and
the output head) × the tokens of the step, plus causal attention's QKᵀ
and PV, forward and backward (3 × the forward's 4·Dh FLOPs for each
allowed query-key pair of each head).  Recompute and capacity padding are
not counted, so a change that removes work cannot raise the share.
"""
from __future__ import annotations

from typing import Mapping

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core rate (no sparsity)
# and HBM3 bandwidth, one card at its 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# device kernel groups by name, tried in this order (first match wins);
# K1 and K3 are the port's hand-written kernels (``csrc/gossip_update.cu``,
# ``csrc/l2_norms.cu``), the matmul patterns cuBLAS's and CUTLASS's names
KERNEL_GROUPS = (
    ("update_mix", ("program_update_kernel",)),
    ("probe", ("partial_kernel", "finish_kernel")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas", "splitkreduce")),
)


def kernel_group(name: str) -> str:
    """``update_mix``, ``probe``, ``matmul`` or ``other``."""
    low = name.lower()
    for group, patterns in KERNEL_GROUPS:
        if any(p.lower() in low for p in patterns):
            return group
    return "other"


def head_dim(cfg: Mapping) -> int:
    return cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]


def matmul_params_per_token(cfg: Mapping) -> int:
    """Matrix-multiply parameters one token touches in a forward pass."""
    d, dh = cfg["d_model"], head_dim(cfg)
    attn = d * dh * (2 * cfg["n_heads"] + 2 * cfg["n_kv"])
    if cfg.get("n_experts"):
        ffn = d * cfg["n_experts"] + cfg["top_k"] * 3 * d * cfg["d_ff"]
    else:
        ffn = 3 * d * cfg["d_ff"]
    return cfg["n_layers"] * (attn + ffn) + d * cfg["vocab"]


def attention_pairs(seq: int, *, causal: bool = True) -> int:
    """Allowed (query, key) pairs of one head over one sequence."""
    return seq * (seq + 1) // 2 if causal else seq * seq


def model_flops_per_step(cfg: Mapping, *, nodes: int, per_node_batch: int, seq: int,
                         causal: bool = True) -> int:
    """Model FLOPs of one training step of every node (forward and
    backward)."""
    tokens = nodes * per_node_batch * seq
    dense = 6 * matmul_params_per_token(cfg) * tokens
    pairs = nodes * per_node_batch * attention_pairs(seq, causal=causal)
    attn = 3 * 4 * head_dim(cfg) * cfg["n_heads"] * pairs * cfg["n_layers"]
    return dense + attn


def update_mix_least_bytes(nodes: int, params: int, elem_bytes: int) -> int:
    """θ, the gradient and the float32 momentum read once, θ' and m'
    written once: the work of the update and the mix, whatever kernels do
    it (14 B a bf16 parameter)."""
    return nodes * params * (3 * elem_bytes + 8)


def probe_least_bytes(nodes: int, params: int, n_leaves: int, elem_bytes: int) -> int:
    """θ read once and the (nodes, n_leaves) float32 norms written once."""
    return nodes * params * elem_bytes + nodes * n_leaves * 4


def least_seconds(nbytes: float) -> float:
    """The least time the card's memory takes to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
