"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

Gossip placement is hierarchical (DESIGN.md §4): a replica needs a full
256-chip pod (FSDP x EP), so decentralization runs across pods only.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, d_head=112,
    d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, n_shared_experts=1,
    source="arXiv:2501.kimi2",
)
