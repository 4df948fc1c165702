"""zamba2-7b — Mamba2 blocks + shared attention block [arXiv:2411.15242].

81 blocks, every 6th is the (weight-shared) attention+MLP block:
13 groups of [5 mamba2 + shared attn] + 3 tail mamba2 blocks.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336, vocab=32000,
    ssm_state=64, attn_every=6,
    source="arXiv:2411.15242",
)
