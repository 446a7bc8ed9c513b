"""Whisper-style encoder-decoder backbone (the audio family).

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, D).  Encoder layers are
bidirectional self-attention; decoder layers are causal self-attention,
cross-attention over the encoder's states, and an MLP.  Sinusoidal
positions on both streams.

The reference stacks each stack's layer parameters on a leading axis
(``jax.vmap`` of the layer init) and scans over them; here ``encoder`` and
``decoder`` are ``nn.ModuleList``s walked by a Python loop, and the decode
state is a list with one ``{"self", "cross"}`` pair of KV caches per
decoder layer.  Every attention runs through the port's kernels: the
encoder unmasked and the decoder's self-attention causally through the
flash-attention kernel, cross-attention through it unmasked over
``Tq != Tk`` in training, and through the split-KV decode kernel over the
whole encoder cache when decoding.

Decode: the self-attention cache holds ``max_len`` positions; the
cross-attention cache is the encoder's keys and values, filled once by
``prefill_cross``.

Over a mesh of ranks (``EncDec.shard``, the machinery ``LM`` has:
``lm.Sharded``) each rank computes its heads of every self- and
cross-attention (and the kv heads they read, which its cross caches hold
under ``kv_shard="heads"``), its ``ff`` columns of the MLPs and its slice
of the vocabulary, where the rank count divides it (whisper-base's 51865
stays whole: the reference's fallback).  The residual streams stay whole
on every rank (no ``seq_parallel`` rows), and the model has no experts: an
expert axis splits nothing.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..dist.sharding import ComputeLayout, region
from .attention import (attention_region, decode_attention, full_attention,
                        init_attention, init_kv_cache, precompute_cross_kv)
from .config import ArchConfig
from .layers import (apply_mlp, apply_norm, init_embed, init_mlp, init_norm,
                     mlp_region, sinusoidal_positions, torch_dtype)
from .lm import (Sharded, check_remat, chunked_xent, missing_layer,
                 serving_dtype)

__all__ = ["EncDec"]


def _init_enc_layer(gen, cfg: ArchConfig, device) -> nn.ModuleDict:
    return nn.ModuleDict({"norm1": init_norm(cfg, device),
                          "mixer": init_attention(gen, cfg, device),
                          "norm2": init_norm(cfg, device),
                          "channel": init_mlp(gen, cfg, device)})


def _init_dec_layer(gen, cfg: ArchConfig, device) -> nn.ModuleDict:
    return nn.ModuleDict({"norm1": init_norm(cfg, device),
                          "self": init_attention(gen, cfg, device),
                          "norm_x": init_norm(cfg, device),
                          "cross": init_attention(gen, cfg, device,
                                                  cross=True),
                          "norm2": init_norm(cfg, device),
                          "channel": init_mlp(gen, cfg, device)})


def _enc_layer(p, h: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor) -> torch.Tensor:
    h = h + full_attention(p["mixer"], apply_norm(p["norm1"], h, cfg), cfg,
                           positions=positions, causal=False)
    return h + apply_mlp(p["channel"], apply_norm(p["norm2"], h, cfg), cfg)


def _dec_layer(p, h: torch.Tensor, enc: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor) -> torch.Tensor:
    h = h + full_attention(p["self"], apply_norm(p["norm1"], h, cfg), cfg,
                           positions=positions, causal=True)
    h = h + full_attention(p["cross"], apply_norm(p["norm_x"], h, cfg), cfg,
                           positions=positions, causal=False, kv_states=enc)
    return h + apply_mlp(p["channel"], apply_norm(p["norm2"], h, cfg), cfg)


class EncDec(Sharded):
    """Encoder-decoder with random weights drawn from ``seed`` on
    ``device`` (``None`` = the card; ``"meta"`` makes the shapes only)."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device=None):
        super().__init__()
        missing = missing_layer(cfg)
        if missing is not None:
            raise NotImplementedError(
                f"{cfg.name}: {missing} is not ported to repro_torch yet")
        if not cfg.encdec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        dev = resolve_device(device)
        gen = None
        if dev.type != "meta":
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        self.embed = init_embed(gen, cfg, dev)
        self.encoder = nn.ModuleList(_init_enc_layer(gen, cfg, dev)
                                     for _ in range(cfg.n_encoder_layers))
        self.enc_norm = init_norm(cfg, dev)
        self.decoder = nn.ModuleList(_init_dec_layer(gen, cfg, dev)
                                     for _ in range(cfg.n_layers))
        self.final_norm = init_norm(cfg, dev)

    @property
    def device(self) -> torch.device:
        return self.embed["tokens"].device

    def cast_for_serving(self) -> "EncDec":
        """Cast every weight, once, to the dtype the reference reads it in
        (``serving_dtype``: float32 norms, the compute dtype elsewhere)."""
        for name, p in self.named_parameters():
            p.data = p.data.to(serving_dtype(name, self.cfg))
        return self

    def decay_mask(self) -> dict[str, bool]:
        """Which parameters AdamW decays, by name: the reference's rule
        (``ndim >= 2``) on its tree, where every encoder and decoder layer
        parameter carries a leading layer axis.  So each layer's norm
        scales and biases are decayed too, and ``enc_norm`` and
        ``final_norm`` are not."""
        return {name: p.dim() + name.startswith(("encoder.", "decoder."))
                >= 2 for name, p in self.named_parameters()}

    # -- ranks ---------------------------------------------------------------
    def _layer_region(self, parts: list[str], shape,
                      cl: ComputeLayout) -> tuple:
        """Every attention's heads (self and cross), the MLPs' ``ff``
        columns."""
        if parts[0] not in ("encoder", "decoder") or len(parts) != 4:
            return region(shape)
        sub, leaf = parts[2], parts[3]
        if sub in ("mixer", "self", "cross"):
            return attention_region(leaf, shape, self.cfg, cl)
        if sub == "channel":
            return mlp_region(leaf, shape, cl)
        return region(shape)

    def _stack(self, layers: nn.ModuleList, prefix: str, fn, x, *args,
               remat: bool | str = False):
        """``x`` through ``fn(p, x, *args)`` for each layer's compute
        blocks ``p`` (gathered once, kept for the backward)."""
        for i, layer in enumerate(layers):
            p = self._tree(layer, f"{prefix}.{i}.")
            if remat:
                x = checkpoint(self._in_rules, fn, p, x, *args,
                               use_reentrant=False)
            else:
                x = fn(p, x, *args)
        return x

    # -- encoder -----------------------------------------------------------------
    def encode(self, frames: torch.Tensor,
               remat: bool | str = False) -> torch.Tensor:
        """Frame embeddings (B, S_enc, D) -> the encoder's states, the
        sinusoidal positions added; ``remat`` recomputes each layer in the
        backward pass."""
        check_remat(remat)
        with self._rules():
            return self._encode(frames, remat)

    def _encode(self, frames: torch.Tensor, remat) -> torch.Tensor:
        cfg = self.cfg
        dtc = torch_dtype(cfg.compute_dtype)
        b, s = frames.shape[:2]
        pos = sinusoidal_positions(s, cfg.d_model, frames.device).to(dtc)
        x = frames.to(dtc) + pos
        positions = torch.arange(s, device=x.device).expand(b, s)
        x = self._stack(self.encoder, "encoder", _enc_layer, x, cfg,
                        positions, remat=remat)
        return apply_norm(self._tree(self.enc_norm, "enc_norm."), x, cfg)

    # -- decoder (teacher-forced training) ------------------------------------------
    def decode_train(self, tokens: torch.Tensor, enc: torch.Tensor,
                     remat: bool | str = False) -> torch.Tensor:
        check_remat(remat)
        cfg = self.cfg
        dtc = torch_dtype(cfg.compute_dtype)
        with self._rules():
            x = self._embed(tokens)
            b, t = x.shape[:2]
            x = x + sinusoidal_positions(t, cfg.d_model, x.device).to(dtc)
            positions = torch.arange(t, device=x.device).expand(b, t)
            x = self._stack(self.decoder, "decoder", _dec_layer, x, enc, cfg,
                            positions, remat=remat)
            return apply_norm(self._tree(self.final_norm, "final_norm."), x,
                              cfg)

    def loss(self, batch: dict, *, remat: bool | str = False
             ) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross-entropy of the decoder over ``batch``
        (``frame_embeds`` (B, S_enc, D), ``tokens``, ``labels``, optional
        ``loss_mask``); returns (loss, {"xent", "aux"}), aux 0."""
        enc = self.encode(batch["frame_embeds"], remat=remat)
        h = self.decode_train(batch["tokens"], enc, remat=remat)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        with self._rules():
            xent = chunked_xent(h, self._head_w(), labels, mask, self.cfg)
        return xent, {"xent": xent,
                      "aux": torch.zeros((), dtype=torch.float32,
                                         device=xent.device)}

    # -- serving -----------------------------------------------------------------
    def init_decode_state(self, batch: int, max_len: int,
                          cross_len: int = 1024) -> list[dict]:
        with self._rules():
            return [{"self": init_kv_cache(self.cfg, batch, max_len,
                                           self.device),
                     "cross": init_kv_cache(self.cfg, batch, cross_len,
                                            self.device)}
                    for _ in range(self.cfg.n_layers)]

    @torch.inference_mode()
    def prefill_cross(self, state: list[dict],
                      frames: torch.Tensor) -> list[dict]:
        """Run the encoder and fill the cross-attention caches (each
        becomes the encoder's keys and values, whatever its length)."""
        enc = self.encode(frames)
        return [{"self": s["self"],
                 "cross": precompute_cross_kv(
                     self._tree(layer["cross"], f"decoder.{i}.cross."), enc,
                     self.cfg)}
                for i, (layer, s) in enumerate(zip(self.decoder, state))]

    @torch.inference_mode()
    def decode_step(self, state: list[dict], tokens: torch.Tensor,
                    pos: int) -> tuple[torch.Tensor, list[dict]]:
        """tokens: (B, 1) at position ``pos`` -> (logits (B, 1, V) float32,
        state); each self-attention cache is written at ``pos`` in place.
        The position embedding is row ``min(pos, decoder_len)`` of the
        sinusoidal table, as in the reference."""
        with self._rules():
            return self._decode_step(state, tokens, int(pos))

    def _decode_step(self, state, tokens, pos: int):
        cfg = self.cfg
        dtc = torch_dtype(cfg.compute_dtype)
        x = self._embed(tokens)
        table = sinusoidal_positions(cfg.decoder_len + 1, cfg.d_model,
                                     x.device)
        x = x + table[min(pos, cfg.decoder_len)].to(dtc)
        for i, s in enumerate(state):
            layer = self._tree(self.decoder[i], f"decoder.{i}.")
            a, s["self"] = decode_attention(
                layer["self"], apply_norm(layer["norm1"], x, cfg), s["self"],
                cfg, pos=pos)
            x = x + a
            c, _ = decode_attention(
                layer["cross"], apply_norm(layer["norm_x"], x, cfg),
                s["cross"], cfg, pos=pos, cross=True)
            x = x + c
            x = x + apply_mlp(layer["channel"],
                              apply_norm(layer["norm2"], x, cfg), cfg)
        x = apply_norm(self._tree(self.final_norm, "final_norm."), x, cfg)
        return self._logits(x), state
