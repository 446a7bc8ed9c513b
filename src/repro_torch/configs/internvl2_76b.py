"""InternVL2-76B — InternViT frontend (STUB) + LLaMA-70B-shape backbone.

[arXiv:2404.16821; unverified]  80L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256.  The ViT is a stub: input_specs feeds
precomputed patch embeddings.
"""
from ..models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        mlp_type="swiglu",
        rope_theta=500_000.0,
        frontend="stub_patches",
        n_patches=1024,
        source="[arXiv:2404.16821; unverified]",
    )
