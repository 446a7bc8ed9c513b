"""Jamba-v0.1 52B — hybrid Mamba + attention (1:7), MoE 16e top-2.

[arXiv:2403.19887; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; attention at layer index 4 of each 8-layer block
(attn_layer_period=8, offset=4); MoE every other layer (period=2,
offset=1); mamba d_state=16 d_conv=4 expand=2, dt_rank=256.

No positional embeddings (the Mamba layers carry position information).
"""
from ..models.config import ArchConfig, MambaConfig, MoEConfig

_KINDS = tuple("attn" if i % 8 == 4 else "mamba" for i in range(32))


def full() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        mlp_type="swiglu",
        layer_kinds=_KINDS,
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336,
                      layer_period=2, layer_offset=1),
        positions="none",
        source="[arXiv:2403.19887; hf]",
    )
