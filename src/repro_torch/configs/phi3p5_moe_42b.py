"""Phi-3.5-MoE 42B (6.6B active) — 16 experts top-2.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]  32L d_model=4096 32H (GQA kv=8)
expert d_ff=6400 vocab=32064.
"""
from ..models.config import ArchConfig, MoEConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        mlp_type="swiglu",
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=6400),
        source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
    )
