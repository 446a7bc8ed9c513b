"""Decoder-only language model: embed -> layers -> norm -> loss or head.

The reference stacks each scan group's parameters along a leading axis
(``jax.vmap`` of ``init_group``) and scans over them; here the layers are
an ``nn.ModuleList`` walked by a Python loop, and the decode state is a
list with one entry per layer: a KV cache (attention, written in place), a
conv window and ssm state (mamba), or the shifted tokens and wkv state
(rwkv).

Training: ``loss`` runs ``backbone`` (optionally with each layer under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` remat with
nothing saved) and ``chunked_xent``, which never holds the full
(B, T, V) logits in one piece.  Serving (``prefill``, ``decode_step``)
runs under ``torch.inference_mode()``: the parameters require grad, and
the KV caches are written in place.

Serving and training run every mixer kind and the MoE channel.  The VLM
frontend (``frontend="stub_patches"``) prepends precomputed patch
embeddings to the token embeddings and masks them out of the loss; the
encoder-decoder family is ``models/encdec.py``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from .blocks import (MIXERS, apply_layer, decode_layer, init_layer,
                     init_layer_state, prefill_layer)
from .config import ArchConfig
from .layers import (apply_norm, embed_tokens, init_embed, init_norm,
                     torch_dtype)

__all__ = ["FLOAT32_LEAVES", "FRONTENDS", "LM", "POSITIONS", "check_remat",
           "chunked_xent", "missing_layer", "serving_dtype"]

# leaves the reference reads in float32 whatever the compute dtype: the
# mamba scan's A_log, D, dt_bias and dt_proj (models/mamba.py _ssm_inputs)
# and the rwkv decay_base, bonus u and post-wkv norm's ln_scale/ln_bias
# (models/rwkv6.py apply_rwkv_tmix)
FLOAT32_LEAVES = frozenset({"A_log", "D", "dt_bias", "dt_proj", "decay_base",
                            "u", "ln_scale", "ln_bias"})


def chunked_xent(h: torch.Tensor, head_w: torch.Tensor,
                 targets: torch.Tensor, mask: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Mean cross-entropy over masked positions, chunked along T.

    h: (B, T, D); head_w: (D, V); targets/mask: (B, T).  The chunk is the
    largest divisor of T up to ``cfg.logit_chunk``; each chunk's logits are
    a ``compute_dtype`` product taken to float32 for the logsumexp.
    """
    t = h.shape[1]
    c = min(cfg.logit_chunk, t)
    while t % c:
        c -= 1
    dtc = torch_dtype(cfg.compute_dtype)
    w = head_w.to(dtc)                  # cast once, not once per chunk
    targets = targets.long()
    mask = mask.float()
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, t, c):
        logits = (h[:, i:i + c].to(dtc) @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, targets[:, i:i + c, None])[..., 0]
        loss_sum = loss_sum + ((lse - ll) * mask[:, i:i + c]).sum()
    return loss_sum / mask.sum().clamp_min(1.0)


# the frontends and position kinds the port runs: "stub_frames" and
# "sinusoidal" are the encoder-decoder's (models/encdec.py)
FRONTENDS = ("tokens", "stub_patches", "stub_frames")
POSITIONS = ("rope", "none", "sinusoidal")


def missing_layer(cfg: ArchConfig) -> str | None:
    """The first part of ``cfg`` the port cannot run, or ``None``."""
    if cfg.frontend not in FRONTENDS:
        return f"the {cfg.frontend!r} frontend"
    for kind in cfg.layer_kinds:
        if kind not in MIXERS:
            return f"the {kind!r} mixer"
    if cfg.positions not in POSITIONS:
        return f"{cfg.positions!r} positions"
    return None


def check_remat(remat: bool | str) -> None:
    """``remat`` True or ``"full"`` recomputes each layer from its input;
    the reference's ``"save_dots"`` policy is not ported."""
    if remat == "save_dots":
        raise NotImplementedError(
            "remat='save_dots' (the reference's save_only_these_names "
            "policy) is not ported; use remat=True")
    if remat not in (False, True, "full"):
        raise ValueError(f"remat={remat!r}")


def serving_dtype(name: str, cfg: ArchConfig) -> torch.dtype:
    """The dtype the reference reads parameter ``name`` in when it serves:
    float32 for the norms and ``FLOAT32_LEAVES``, else ``compute_dtype``."""
    if "norm" in name or name.rsplit(".", 1)[-1] in FLOAT32_LEAVES:
        return torch.float32
    return torch_dtype(cfg.compute_dtype)


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
        self.kinds = tuple(cfg.layer_kinds)
        self.moe_mask = cfg.moe_layer_mask()
        self.layers = nn.ModuleList(
            init_layer(gen, cfg, kind, self.moe_mask[i], dev)
            for i, kind in enumerate(self.kinds))
        self.final_norm = init_norm(cfg, dev)

    @property
    def device(self) -> torch.device:
        return self.embed["tokens"].device

    def cast_for_serving(self) -> "LM":
        """Cast every weight, once, to the dtype the reference reads it in
        (``serving_dtype``): the compute dtype for the products' weights,
        float32 for the norms and the recurrences' float32 leaves.

        The reference casts each weight at each use (``.astype(dt)``),
        which gives the same numbers; a float32 leaf cast to bf16 once and
        back at each use would not.
        """
        for name, p in self.named_parameters():
            p.data = p.data.to(serving_dtype(name, self.cfg))
        return self

    def decay_mask(self) -> dict[str, bool]:
        """Which parameters AdamW decays, by name: those the reference's
        rule (``ndim >= 2``) decays in its tree, where every layer
        parameter carries a leading scan-group axis.  So each layer's norm
        scales are decayed too, and of the 1-D parameters only the final
        norm's are not."""
        return {name: p.dim() + name.startswith("layers.") >= 2
                for name, p in self.named_parameters()}

    def _head_w(self) -> torch.Tensor:
        return (self.embed["tokens"].T if self.cfg.tie_embeddings
                else self.embed["lm_head"])

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        dtc = torch_dtype(self.cfg.compute_dtype)
        return (h.to(dtc) @ self._head_w().to(dtc)).float()

    # -- training --------------------------------------------------------------
    def backbone(self, x: torch.Tensor, positions: torch.Tensor,
                 remat: bool | str = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """The layers and the final norm; returns (h, summed aux loss).

        ``remat`` True or ``"full"`` recomputes each layer in the backward
        pass from its input (``torch.utils.checkpoint``, nothing saved
        inside the layer: the reference's default policy).
        """
        check_remat(remat)
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer, kind, is_moe in zip(self.layers, self.kinds,
                                       self.moe_mask):
            if remat:
                x, a = checkpoint(apply_layer, layer, x, cfg, kind, is_moe,
                                  positions, use_reentrant=False)
            else:
                x, a = apply_layer(layer, x, cfg, kind, is_moe, positions)
            aux = aux + a
        return apply_norm(self.final_norm, x, cfg), aux

    def embed_inputs(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor, torch.Tensor]:
        """Returns (x, positions, targets, loss_mask).  A VLM's
        ``patch_embeds`` (B, P, D), where the batch has them, are
        prepended to the token embeddings, with target 0 and loss mask 0
        over the patches; without them the VLM runs on its text alone."""
        tokens = batch["tokens"]
        x = embed_tokens(self.embed, tokens, self.cfg)
        targets = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=targets.device)
        patches = batch.get("patch_embeds")
        if self.cfg.frontend == "stub_patches" and patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)
            n = patches.shape[:2]
            targets = torch.cat([torch.zeros(n, dtype=targets.dtype,
                                             device=targets.device),
                                 targets], dim=1)
            mask = torch.cat([torch.zeros(n, dtype=mask.dtype,
                                          device=mask.device), mask], dim=1)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        return x, positions, targets, mask

    def loss(self, batch: dict, *, remat: bool | str = False
             ) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross-entropy of ``batch`` (``tokens``,
        ``labels``, optional ``loss_mask``, all (B, T)) plus the weighted
        aux loss; returns (loss, {"xent", "aux"})."""
        cfg = self.cfg
        x, positions, targets, mask = self.embed_inputs(batch)
        h, aux = self.backbone(x, positions, remat=remat)
        xent = chunked_xent(h, self._head_w(), targets, mask, cfg)
        aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
        total = xent + aux_w * aux / max(cfg.n_layers, 1)
        return total, {"xent": xent, "aux": aux}

    # -- prefill ---------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, max_len: int = 0,
                patch_embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, list[dict]]:
        """Process a full prompt (B, S), after a VLM's ``patch_embeds``
        (B, P, D) where given; returns (last-position logits (B, 1, V)
        float32, decode state).  Attention layers' KV caches are padded to
        ``max_len`` positions (at least the prompt's P + S); the recurrent
        layers' states are their prefill's.  Where the active rules shard
        the cache sequence, every rank runs the whole prompt and keeps the
        keys and values of its stripe ``[s0, s0 + S_local)``."""
        cfg = self.cfg
        batch = {"tokens": tokens, "labels": torch.zeros_like(tokens)}
        if patch_embeds is not None:
            batch["patch_embeds"] = patch_embeds
        x, positions, _, _ = self.embed_inputs(batch)
        b, s = x.shape[:2]
        max_len = max(max_len, s)
        states = []
        for layer, kind, is_moe in zip(self.layers, self.kinds,
                                       self.moe_mask):
            x, state = prefill_layer(layer, x, cfg, kind, is_moe, positions)
            if kind == "attn":
                cache = init_layer_state(cfg, kind, b, max_len, x.device)
                stripe = cache.get("stripe")
                s0, n = (0, s) if stripe is None else (
                    stripe.s0, max(0, min(s, stripe.s0 + stripe.length)
                                   - stripe.s0))
                cache["k"][:, :n] = state["k"][:, s0:s0 + n]
                cache["v"][:, :n] = state["v"][:, s0:s0 + n]
                state = cache
            states.append(state)
        x = apply_norm(self.final_norm, x, cfg)
        return self._logits(x[:, -1:]), states

    # -- decode ----------------------------------------------------------------
    def init_decode_state(self, batch: int, max_len: int) -> list[dict]:
        return [init_layer_state(self.cfg, kind, batch, max_len, self.device)
                for kind in self.kinds]

    @torch.inference_mode()
    def decode_step(self, state: list[dict], tokens: torch.Tensor,
                    pos: int) -> tuple[torch.Tensor, list[dict]]:
        """tokens: (B, 1) at position ``pos`` -> (logits (B, 1, V),
        state); each attention layer's cache is written at ``pos`` in
        place, each recurrent layer's state replaced by its next."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, cfg)
        for i, layer in enumerate(self.layers):
            x, state[i] = decode_layer(layer, x, state[i], cfg, self.kinds[i],
                                       self.moe_mask[i], int(pos))
        x = apply_norm(self.final_norm, x, cfg)
        return self._logits(x), state
