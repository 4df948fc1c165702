"""Architecture config registry: ``get_config("<arch-id>")``.

Every architecture of the reference registry is known by name; only the
ported ones load, the others raise "not yet ported" (ROADMAP queue 1
item 6 brings the model zoo).
"""
from repro_torch.configs.base import ArchConfig

_MODULES = {
    "phi3.5-moe-42b-a6.6b": None,
    "stablelm-12b": None,
    "granite-8b": "granite_8b",
    "kimi-k2-1t-a32b": None,
    "rwkv6-1.6b": None,
    "musicgen-medium": None,
    "zamba2-7b": None,
    "starcoder2-7b": None,
    "internvl2-2b": None,
    "qwen2.5-14b": None,
}

ARCH_NAMES = tuple(_MODULES)
PORTED = tuple(k for k, v in _MODULES.items() if v is not None)


def get_config(name: str) -> ArchConfig:
    import importlib

    reduced = name.endswith("-reduced")
    base = name[: -len("-reduced")] if reduced else name
    if base not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    if _MODULES[base] is None:
        raise ValueError(
            f"arch {base!r} is not yet ported (ported: {PORTED}); the model "
            "zoo is ROADMAP queue 1 item 6"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[base]}")
    cfg = mod.CONFIG
    return cfg.reduced() if reduced else cfg
