"""qwen2.5-14b — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family].

H=40 does not divide the 16-way model axis: contraction-dim TP fallback.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=13824, vocab=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
    pad_heads=True,  # §Perf H3: exact grouped head padding (16x attention win)
    source="hf:Qwen/Qwen2.5-0.5B",
)
