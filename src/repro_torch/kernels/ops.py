"""Public wrappers of the port's kernels (the counterpart of
``repro/kernels/ops.py``).

Each wrapper launches its hand-written CUDA kernel for CUDA tensors and
takes its plain twin for CPU tensors; there is no fallback from one to the
other.  ``launch_counts``/``reset_launch_counts`` read and clear the
per-kernel launch counters.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_update import (
    fused_apply_shard, fused_apply_stacked, gossip_program_update, gossip_update,
)
from repro_torch.kernels.stats import l2_norms, segment_l2_norms

__all__ = [
    "flash_attention",
    "gossip_program_update",
    "gossip_update",
    "fused_apply_stacked",
    "fused_apply_shard",
    "l2_norms",
    "segment_l2_norms",
    "launch_counts",
    "reset_launch_counts",
]

_COUNTED = {
    "gossip_program_update": gossip_program_update,
    "gossip_update": gossip_update,
    "segment_l2_norms": segment_l2_norms,
    "flash_attention": flash_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
