"""Architecture registry: one module per assigned architecture.

``get(name)`` returns the full-scale ArchConfig; ``get(name).smoke()``
returns the reduced same-family config used by CPU smoke tests.
"""

from __future__ import annotations

from ..models.config import ArchConfig

from . import (internvl2_76b, jamba_v0p1_52b, nemotron4_340b, phi3_mini_3p8b,
               phi3p5_moe_42b, phi4_mini_3p8b, qwen2_moe_a2p7b, qwen2p5_3b,
               rwkv6_1p6b, whisper_base)

_MODULES = {
    "rwkv6-1.6b": rwkv6_1p6b,
    "internvl2-76b": internvl2_76b,
    "nemotron-4-340b": nemotron4_340b,
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "phi3-mini-3.8b": phi3_mini_3p8b,
    "qwen2.5-3b": qwen2p5_3b,
    "qwen2-moe-a2.7b": qwen2_moe_a2p7b,
    "phi3.5-moe-42b-a6.6b": phi3p5_moe_42b,
    "jamba-v0.1-52b": jamba_v0p1_52b,
    "whisper-base": whisper_base,
}

ARCH_NAMES = tuple(_MODULES)


def get(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    return _MODULES[name].full()


def all_archs() -> dict[str, ArchConfig]:
    return {name: get(name) for name in ARCH_NAMES}
