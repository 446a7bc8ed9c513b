"""Whisper-base — encoder-decoder audio backbone; conv frontend STUB.

[arXiv:2212.04356; unverified]  6L enc + 6L dec, d_model=512 8H
d_ff=2048 vocab=51865, LayerNorm + GELU.  input_specs feeds precomputed
frame embeddings.
"""
from ..models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        mlp_type="gelu",
        norm_type="layernorm",
        encdec=True,
        n_encoder_layers=6,
        decoder_len=448,
        frontend="stub_frames",
        positions="sinusoidal",
        tie_embeddings=True,
        source="[arXiv:2212.04356; unverified]",
    )
