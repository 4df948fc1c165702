"""The frozen yardstick: the card's peaks, the least bytes of the
update-and-mix and of the probe, and the groups the device trace sorts
kernels into by name.  A step's model FLOPs, the work the model needs and
not what the program dispatches, are each model's own count, from its
shapes alone: ``model_flops_per_step`` of the configuration's reference
module (``perfbench/references/``), which ``cell.py`` puts in the
readers' context.

Nothing here reads the program: a later change to the program cannot move
what a metric is measured against.
"""
from __future__ import annotations

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


def update_mix_least_bytes(nodes: int, params: int, param_bytes: int) -> int:
    """θ, the gradient and the float32 momentum read once, θ' and m'
    written once: the work of the update and the mix, whatever kernels do
    it (14 B a bf16 parameter).  ``param_bytes``: one node's parameters,
    each leaf at its own dtype's size."""
    return nodes * (3 * param_bytes + 8 * params)


def probe_least_bytes(nodes: int, param_bytes: int, n_leaves: int) -> int:
    """θ read once (each leaf at its own dtype's size) and the (nodes,
    n_leaves) float32 norms written once."""
    return nodes * param_bytes + nodes * n_leaves * 4


def least_seconds(nbytes: float) -> float:
    """The least time the card's memory takes to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
