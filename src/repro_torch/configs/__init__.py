"""Architecture config registry: ``get_config("<arch-id>")``.

The reference registry's ten architectures, one module each, with the
reference's numbers and sources; ``"<arch-id>-reduced"`` gives the CPU
smoke-test variant of the same family.
"""
from repro_torch.configs.base import ArchConfig

_MODULES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "stablelm-12b": "stablelm_12b",
    "granite-8b": "granite_8b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "rwkv6-1.6b": "rwkv6_1b6",
    "musicgen-medium": "musicgen_medium",
    "zamba2-7b": "zamba2_7b",
    "starcoder2-7b": "starcoder2_7b",
    "internvl2-2b": "internvl2_2b",
    "qwen2.5-14b": "qwen25_14b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    import importlib

    reduced = name.endswith("-reduced")
    base = name[: -len("-reduced")] if reduced else name
    if base not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[base]}")
    cfg = mod.CONFIG
    return cfg.reduced() if reduced else cfg
