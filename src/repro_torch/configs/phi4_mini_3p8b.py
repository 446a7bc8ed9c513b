"""Phi-4-mini 3.8B — dense, RoPE + SwiGLU, GQA kv=8, 200k vocab.

[arXiv:2412.08905; hf]  32L d_model=3072 24H d_ff=8192 vocab=200064.
"""
from ..models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        mlp_type="swiglu",
        tie_embeddings=True,
        source="[arXiv:2412.08905; hf]",
    )
