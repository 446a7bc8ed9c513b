"""Qwen2-MoE A2.7B — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (kv=16)
moe d_ff=1408, shared expert d_ff=5632, vocab=151936.
"""
from ..models.config import ArchConfig, MoEConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        mlp_type="swiglu",
        qkv_bias=True,
        moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                      n_shared=4, d_shared=5632),
        source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
    )
