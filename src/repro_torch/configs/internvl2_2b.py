"""internvl2-2b — InternViT + InternLM2 backbone [arXiv:2404.16821].

The ViT/projector frontend is stubbed per the harness spec:
``input_specs()`` supplies 1024 precomputed patch embeddings at d_model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192, vocab=92553,
    input_kind="vlm", n_patches=1024,
    source="arXiv:2404.16821",
)
