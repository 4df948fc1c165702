"""starcoder2-7b — GQA kv=4, RoPE [arXiv:2402.19173].

H=36 does not divide the 16-way model axis: contraction-dim TP fallback.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv=4, d_ff=18432, vocab=49152,
    norm="layernorm", act="gelu",
    pad_heads=True,  # §Perf H3: exact grouped head padding (16x attention win)
    source="arXiv:2402.19173",
)
