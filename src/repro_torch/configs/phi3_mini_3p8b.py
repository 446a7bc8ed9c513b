"""Phi-3-mini 3.8B — dense, RoPE + SwiGLU, kv=32 (MHA).

[arXiv:2404.14219; unverified]  32L d_model=3072 32H d_ff=8192 vocab=32064.
"""
from ..models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        mlp_type="swiglu",
        source="[arXiv:2404.14219; unverified]",
    )
