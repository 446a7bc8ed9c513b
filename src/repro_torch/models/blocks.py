"""Layer assembly: (norm -> mixer -> residual) + (norm -> channel -> residual).

The port runs the dense decoder layer: a grouped-query attention mixer and
a dense MLP.  The reference's other mixers (mamba, rwkv) and its MoE
channel arrive with the slices that port their kernels; asking for one
raises ``NotImplementedError``.  A dense stack has a group size of one, so
the reference's per-group helpers become a plain list of layers
(``LM.layers``).
"""

from __future__ import annotations

import torch
from torch import nn

from .attention import (decode_attention, full_attention, init_attention,
                        init_kv_cache)
from .config import ArchConfig
from .layers import apply_mlp, apply_norm, init_mlp, init_norm

__all__ = ["apply_layer", "decode_layer", "init_layer", "init_layer_state",
           "prefill_layer"]


def init_layer(gen, cfg: ArchConfig, kind: str, is_moe: bool,
               device) -> nn.ModuleDict:
    if kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: the {kind!r} mixer is not ported to repro_torch "
            "yet (only 'attn' is)")
    if is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the MoE channel is not ported to repro_torch yet")
    return nn.ModuleDict({"norm1": init_norm(cfg, device),
                          "norm2": init_norm(cfg, device),
                          "mixer": init_attention(gen, cfg, device),
                          "channel": init_mlp(gen, cfg, device)})


def apply_layer(p, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor) -> tuple[torch.Tensor, float]:
    """Training path. Returns (x, aux loss); a dense layer's aux is 0."""
    h = apply_norm(p["norm1"], x, cfg)
    x = x + full_attention(p["mixer"], h, cfg, positions=positions,
                           causal=True)
    h = apply_norm(p["norm2"], x, cfg)
    return x + apply_mlp(p["channel"], h, cfg), 0.0


def init_layer_state(cfg: ArchConfig, batch: int, max_len: int,
                     device) -> dict:
    return init_kv_cache(cfg, batch, max_len, device)


def prefill_layer(p, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also emits the layer's decode state."""
    h = apply_norm(p["norm1"], x, cfg)
    mixed, state = full_attention(p["mixer"], h, cfg, positions=positions,
                                  causal=True, return_kv=True)
    x = x + mixed
    h = apply_norm(p["norm2"], x, cfg)
    return x + apply_mlp(p["channel"], h, cfg), state


def decode_layer(p, x: torch.Tensor, state: dict, cfg: ArchConfig,
                 pos: int) -> tuple[torch.Tensor, dict]:
    """Single-token decode path. x: (B, 1, D)."""
    h = apply_norm(p["norm1"], x, cfg)
    mixed, state = decode_attention(p["mixer"], h, state, cfg, pos=pos)
    x = x + mixed
    h = apply_norm(p["norm2"], x, cfg)
    return x + apply_mlp(p["channel"], h, cfg), state
