"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec frontend is stubbed per the harness spec: the model consumes the
discrete audio-token stream directly (single-codebook stream modeled;
DESIGN.md §4).  H=24 does not divide the 16-way model axis: attention uses
the contraction-dim TP fallback.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv=24, d_ff=6144, vocab=2048,
    norm="layernorm", act="gelu",
    pad_heads=True,  # §Perf H3: exact grouped head padding (16x attention win)
    source="arXiv:2306.05284",
)
