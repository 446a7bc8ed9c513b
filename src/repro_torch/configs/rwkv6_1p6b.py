"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay.

[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536.
"""
from ..models.config import ArchConfig, RwkvConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,          # wkv heads = d_model / 64
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        layer_kinds=("rwkv",) * 24,
        rwkv=RwkvConfig(head_dim=64),
        positions="none",
        source="[arXiv:2404.05892; unverified]",
    )
