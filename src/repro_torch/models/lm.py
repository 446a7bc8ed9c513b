"""Decoder-only language model for serving: embed -> layers -> norm -> head.

The reference stacks each scan group's parameters along a leading axis
(``jax.vmap`` of ``init_group``) and scans over them; here the layers are
an ``nn.ModuleList`` walked by a Python loop, and the decode state is a
list with one KV cache per layer, updated in place.

Serving only in this slice: ``loss`` and ``chunked_xent`` arrive with the
training slice, as do the families whose layers are not ported yet
(MoE, mamba, rwkv, encoder-decoder, the VLM patch frontend).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from .blocks import decode_layer, init_layer, init_layer_state, prefill_layer
from .config import ArchConfig
from .layers import (apply_norm, embed_tokens, init_embed, init_norm,
                     torch_dtype)

__all__ = ["LM", "missing_layer"]


def missing_layer(cfg: ArchConfig) -> str | None:
    """The first part of ``cfg`` the port cannot run yet, or ``None``."""
    if cfg.encdec:
        return "the encoder-decoder model (models/encdec.py)"
    if cfg.frontend != "tokens":
        return f"the {cfg.frontend!r} frontend (VLM patch embeddings)"
    if cfg.moe is not None:
        return "the MoE layer (models/moe.py)"
    for kind in cfg.layer_kinds:
        if kind != "attn":
            return f"the {kind!r} mixer"
    if cfg.positions != "rope":
        return f"{cfg.positions!r} positions"
    return None


class LM(nn.Module):
    """Decoder-only LM with random weights drawn from ``seed`` on
    ``device`` (``None`` = the card; ``"meta"`` makes the shapes only)."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device=None):
        super().__init__()
        missing = missing_layer(cfg)
        if missing is not None:
            raise NotImplementedError(
                f"{cfg.name}: {missing} is not ported to repro_torch yet")
        self.cfg = cfg
        dev = resolve_device(device)
        gen = None
        if dev.type != "meta":
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        self.embed = init_embed(gen, cfg, dev)
        moe_mask = cfg.moe_layer_mask()
        self.layers = nn.ModuleList(
            init_layer(gen, cfg, kind, moe_mask[i], dev)
            for i, kind in enumerate(cfg.layer_kinds))
        self.final_norm = init_norm(cfg, dev)

    @property
    def device(self) -> torch.device:
        return self.embed["tokens"].device

    def cast_for_serving(self) -> "LM":
        """Cast every weight but the norms' to ``compute_dtype``, once.

        The reference casts each weight at each use (``.astype(dt)``),
        which gives the same numbers; the norms stay in ``param_dtype``
        because the reference reads them in float32.
        """
        dt = torch_dtype(self.cfg.compute_dtype)
        for name, p in self.named_parameters():
            if "norm" not in name:
                p.data = p.data.to(dt)
        return self

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        dtc = torch_dtype(self.cfg.compute_dtype)
        head_w = (self.embed["tokens"].T if self.cfg.tie_embeddings
                  else self.embed["lm_head"])
        return (h.to(dtc) @ head_w.to(dtc)).float()

    # -- prefill ---------------------------------------------------------------
    def prefill(self, tokens: torch.Tensor, *, max_len: int = 0
                ) -> tuple[torch.Tensor, list[dict]]:
        """Process a full prompt (B, S); returns (last-position logits
        (B, 1, V) float32, decode state).  KV caches are padded to
        ``max_len`` positions (at least the prompt length)."""
        cfg = self.cfg
        b, s = tokens.shape
        max_len = max(max_len, s)
        x = embed_tokens(self.embed, tokens, cfg)
        positions = torch.arange(s, device=x.device).expand(b, s)
        states = []
        for layer in self.layers:
            x, kv = prefill_layer(layer, x, cfg, positions)
            cache = init_layer_state(cfg, b, max_len, x.device)
            cache["k"][:, :s] = kv["k"]
            cache["v"][:, :s] = kv["v"]
            states.append(cache)
        x = apply_norm(self.final_norm, x, cfg)
        return self._logits(x[:, -1:]), states

    # -- decode ----------------------------------------------------------------
    def init_decode_state(self, batch: int, max_len: int) -> list[dict]:
        return [init_layer_state(self.cfg, batch, max_len, self.device)
                for _ in self.layers]

    def decode_step(self, state: list[dict], tokens: torch.Tensor,
                    pos: int) -> tuple[torch.Tensor, list[dict]]:
        """tokens: (B, 1) at position ``pos`` -> (logits (B, 1, V),
        state); each layer's cache is written at ``pos`` in place."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, cfg)
        for i, layer in enumerate(self.layers):
            x, state[i] = decode_layer(layer, x, state[i], cfg, int(pos))
        x = apply_norm(self.final_norm, x, cfg)
        return self._logits(x), state
