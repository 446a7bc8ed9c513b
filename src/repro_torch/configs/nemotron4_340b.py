"""Nemotron-4-340B — dense, GQA kv=8, squared-ReLU MLP.

[arXiv:2402.16819; unverified]  96L d_model=18432 96H d_ff=73728
vocab=256000, head_dim=192.
"""
from ..models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        head_dim=192,
        d_ff=73728,
        vocab_size=256000,
        mlp_type="squared_relu",
        source="[arXiv:2402.16819; unverified]",
    )
