"""Qwen2.5-3B — dense, GQA kv=2, QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf]  36L d_model=2048 16H d_ff=11008 vocab=151936.
"""
from ..models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-3b",
        family="dense",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        vocab_size=151936,
        mlp_type="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="[hf:Qwen/Qwen2.5-0.5B; hf]",
    )
