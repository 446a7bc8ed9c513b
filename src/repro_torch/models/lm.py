"""Decoder-only language model: embed -> layers -> norm -> loss or head.

The reference stacks each scan group's parameters along a leading axis
(``jax.vmap`` of ``init_group``) and scans over them; here the layers are
an ``nn.ModuleList`` walked by a Python loop, and the decode state is a
list with one entry per layer: a KV cache (attention, written in place), a
conv window and ssm state (mamba), or the shifted tokens and wkv state
(rwkv).

Training: ``loss`` runs ``backbone`` (optionally with each layer under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` remat with
nothing saved, or cut into checkpointed segments that keep the tensors
its ``"save_dots"`` policy names) and ``chunked_xent``, which never
holds the full (B, T, V) logits in one piece.  Serving (``prefill``,
``decode_step``) runs under ``torch.inference_mode()``: the parameters
require grad, and the KV caches are written in place.

Serving and training run every mixer kind and the MoE channel.  The VLM
frontend (``frontend="stub_patches"``) prepends precomputed patch
embeddings to the token embeddings and masks them out of the loss; the
encoder-decoder family is ``models/encdec.py``.

Over a mesh of ranks (``LM.shard``; the machinery is ``Sharded``, which
``EncDec`` shares) each parameter holds this rank's block of its leaf:
its ``param_specs`` block while training, gathered into the block its
compute needs where a layer uses it (``dist.sharding.gather_leaf``; the
gradient is scattered back), or that compute block itself while serving.
The model's methods run under the layout's rules, so the layers compute
on the rank's heads (attention's and RWKV-6's), ``ff`` columns, vocab
slice, experts and, under ``mamba_tp``, Mamba channels
(``dist.sharding.compute_layout``).
The cross-entropy is then vocab-parallel (a max and two sums over the
ranks a chunk), and the serving logits are gathered whole.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..dist.api import use_rules
from ..dist.collectives import all_gather, all_max, all_reduce
from ..dist.sharding import (ComputeLayout, ParamLayout, compute_layout,
                             leaf_layout, param_specs, region)
from .attention import attention_region
from .blocks import (MIXERS, apply_layer, apply_layer_saving, decode_layer,
                     init_layer, init_layer_state, prefill_layer)
from .config import ArchConfig
from .layers import (apply_norm, embed_tokens, init_embed, init_norm,
                     mlp_region, torch_dtype)
from .mamba import mamba_region
from .rwkv6 import cmix_region, tmix_region

__all__ = ["FLOAT32_LEAVES", "FRONTENDS", "LM", "POSITIONS", "Sharded",
           "check_remat", "chunked_xent", "missing_layer", "serving_dtype"]

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
    a ``compute_dtype`` product taken to float32 for the logsumexp.  Where
    the active rules split the vocabulary over ranks ``head_w`` holds this
    rank's columns, and the chunk's logsumexp and target logit are summed
    over the ranks.
    """
    t = h.shape[1]
    c = min(cfg.logit_chunk, t)
    while t % c:
        c -= 1
    dtc = torch_dtype(cfg.compute_dtype)
    w = head_w.to(dtc)                  # cast once, not once per chunk
    targets = targets.long()
    mask = mask.float()
    cl = compute_layout()
    vocab = None if cl is None else cl.vocab(cfg.vocab_size)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, t, c):
        logits = (h[:, i:i + c].to(dtc) @ w).float()
        tgt = targets[:, i:i + c, None]
        if vocab is None:
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, tgt)[..., 0]
        else:
            # this rank's vocab slice: the max, the sum of exponentials
            # and the target's logit over the ranks
            mesh, axes = cl.mesh, cl.vocab_split.axes
            top = all_max(logits.amax(dim=-1), mesh, axes)
            lse = top + torch.log(all_reduce(
                torch.exp(logits - top[..., None]).sum(-1), mesh, axes))
            local = tgt - vocab.start
            held = (local >= 0) & (local < logits.shape[-1])
            ll = all_reduce((torch.gather(logits, -1, torch.where(
                held, local, 0)) * held)[..., 0], mesh, axes)
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
    ``"save_dots"`` keeps the tensors the reference's policy saves by name
    (``blocks.apply_layer_saving``)."""
    if remat not in (False, True, "full", "save_dots"):
        raise ValueError(f"remat={remat!r}")


def serving_dtype(name: str, cfg: ArchConfig) -> torch.dtype:
    """The dtype the reference reads parameter ``name`` in when it serves:
    float32 for the norms and ``FLOAT32_LEAVES``, else ``compute_dtype``."""
    if "norm" in name or name.rsplit(".", 1)[-1] in FLOAT32_LEAVES:
        return torch.float32
    return torch_dtype(cfg.compute_dtype)


class Sharded(nn.Module):
    """A model whose parameters can be held in blocks over a mesh of ranks
    (``LM`` and ``EncDec``): ``shard`` keeps this rank's block of every
    leaf; ``_leaf``/``_tree`` give the compute blocks where a layer uses
    them, and ``_rules`` the rules its compute follows.  A subclass names
    its leaves' compute regions (``_layer_region``)."""

    # the ParamLayout of a model sharded over ranks (``shard``)
    layout: ParamLayout | None = None

    def compute_region(self, name: str, shape, cl: ComputeLayout) -> tuple:
        """The part of leaf ``name`` (of ``shape``) this rank computes
        with, for ``dist.sharding.leaf_layout``: per dimension ``None``
        (all of it) or ``(range, axes, even)``.  The reference's
        ``constrain`` sites: the vocabulary here, the layers' in
        ``_layer_region``; every other leaf whole."""
        if name == "embed.tokens":
            return region(shape, 0, cl.vocab(shape[0]), cl.vocab_split)
        if name == "embed.lm_head":
            return region(shape, 1, cl.vocab(shape[1]), cl.vocab_split)
        return self._layer_region(name.split("."), shape, cl)

    def _layer_region(self, parts: list[str], shape,
                      cl: ComputeLayout) -> tuple:
        raise NotImplementedError

    def shard(self, rules, resident: str = "storage",
              scfg=None) -> ParamLayout | None:
        """Keep this rank's block of every parameter under ``rules`` (a
        ``MeshRules`` over a ``RankMesh``): its ``param_specs`` block of
        ``scfg`` (``resident="storage"``, training) or its compute block
        (``"compute"``, serving).  Returns the layout, or ``None`` (the
        model untouched) where nothing is split.  Every rank must hold the
        same whole parameters when it is called."""
        mesh = rules.mesh
        cl = ComputeLayout(rules)
        params = dict(self.named_parameters())
        specs = (param_specs(params, mesh, scfg) if resident == "storage"
                 else {n: (None,) * p.dim() for n, p in params.items()})
        leaves = {n: leaf_layout(tuple(p.shape), specs[n],
                                 self.compute_region(n, p.shape, cl), mesh,
                                 cl.batch_axes)
                  for n, p in params.items()}
        if cl.trivial and not any(lay.storage_axes and mesh.axes_size(
                lay.storage_axes) > 1 for lay in leaves.values()):
            return None
        layout = ParamLayout(leaves, rules, resident)
        with torch.no_grad():
            for name, p in params.items():
                p.data = layout.block(name, p.data)
        self.layout = layout
        return layout

    def _rules(self):
        return (contextlib.nullcontext() if self.layout is None
                else use_rules(self.layout.rules))

    def _in_rules(self, fn, *args):
        """``fn(*args)`` under the layout's rules (a layer recomputed by
        remat runs in the backward pass, outside the forward's)."""
        with self._rules():
            return fn(*args)

    def _leaf(self, name: str, p: torch.Tensor) -> torch.Tensor:
        return p if self.layout is None else self.layout.use(name, p)

    def _tree(self, module: nn.Module, prefix: str):
        """``module``'s parameters as its compute blocks (a nested dict
        under the same keys) where the rank stores other blocks."""
        if self.layout is None or self.layout.resident == "compute":
            return module
        out: dict = {}
        for sub, p in module.named_parameters():
            *path, key = sub.split(".")
            node = out
            for k in path:
                node = node.setdefault(k, {})
            node[key] = self.layout.use(prefix + sub, p)
        return out

    def _head_w(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self._leaf("embed.tokens", self.embed["tokens"]).T
        return self._leaf("embed.lm_head", self.embed["lm_head"])

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_tokens({"tokens": self._leaf("embed.tokens",
                                                  self.embed["tokens"])},
                            tokens, self.cfg)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Float32 logits over the whole vocabulary (each rank's slice
        gathered where the rules split it)."""
        dtc = torch_dtype(self.cfg.compute_dtype)
        logits = (h.to(dtc) @ self._head_w().to(dtc)).float()
        cl = compute_layout()
        if cl is None or cl.vocab(self.cfg.vocab_size) is None:
            return logits
        return all_gather(logits, cl.mesh, cl.vocab_split.axes, -1)


class LM(Sharded):
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

    # -- ranks ---------------------------------------------------------------
    def _layer_region(self, parts: list[str], shape,
                      cl: ComputeLayout) -> tuple:
        """Attention's heads, RWKV-6's heads and ``ff`` columns, Mamba's
        channels under ``mamba_tp``, the MLPs' ``ff`` columns (the shared
        expert's too) and the experts."""
        if parts[0] != "layers":
            return region(shape)
        cfg = self.cfg
        i, sub, leaf = int(parts[1]), parts[2], parts[-1]
        kind = self.kinds[i]
        if sub == "mixer":
            if kind == "attn":
                return attention_region(leaf, shape, cfg, cl)
            if kind == "rwkv":
                return tmix_region(leaf, shape, cfg, cl)
            return mamba_region(leaf, shape, cfg, cl)
        if sub != "channel":
            return region(shape)
        if kind == "rwkv":
            return cmix_region(leaf, shape, cfg, cl)
        if self.moe_mask[i] and len(parts) == 4:
            if leaf in ("w_in", "w_gate", "w_out"):
                return region(shape, 0, cl.experts(shape[0]), cl.expert)
            return region(shape)                    # router, shared_gate
        return mlp_region(leaf, shape, cl)

    # -- training --------------------------------------------------------------
    def backbone(self, x: torch.Tensor, positions: torch.Tensor,
                 remat: bool | str = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """The layers and the final norm; returns (h, summed aux loss).

        ``remat`` True or ``"full"`` recomputes each layer in the backward
        pass from its input (``torch.utils.checkpoint``, nothing saved
        inside the layer: the reference's default policy); ``"save_dots"``
        keeps the reference's named tensors (``apply_layer_saving``).
        Over ranks a layer's parameters are gathered into its compute
        blocks once, and the blocks are kept for its backward (under remat
        too: the recompute reads them).  Under ``seq_parallel`` rules the
        layers and the final norm hold this rank's rows, and ``h`` is
        gathered whole.
        """
        check_remat(remat)
        cfg = self.cfg
        cl = compute_layout()
        t = positions.shape[1]
        seq = cl is not None and cl.seq_rows(t) is not None
        if seq:
            x = cl.reduce(x, (), 1)             # this rank's rows
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(len(self.layers)):
            # a layer's parameters as its compute blocks, gathered once:
            # under remat the recompute reads them again, not the ranks
            p = self._tree(self.layers[i], f"layers.{i}.")
            if remat == "save_dots":
                x, a = apply_layer_saving(p, x, cfg, self.kinds[i],
                                          self.moe_mask[i], positions, seq)
            elif remat:
                x, a = checkpoint(self._layer, p, i, x, positions, seq,
                                  use_reentrant=False)
            else:
                x, a = self._layer(p, i, x, positions, seq)
            aux = aux + a
        h = apply_norm(self._tree(self.final_norm, "final_norm."), x, cfg)
        return (cl.gather_seq(h, 1, t) if seq else h), aux

    def _layer(self, p, i: int, x: torch.Tensor, positions: torch.Tensor,
               seq: bool):
        return self._in_rules(apply_layer, p, x, self.cfg, self.kinds[i],
                              self.moe_mask[i], positions, seq)

    def embed_inputs(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor, torch.Tensor]:
        """Returns (x, positions, targets, loss_mask).  A VLM's
        ``patch_embeds`` (B, P, D), where the batch has them, are
        prepended to the token embeddings, with target 0 and loss mask 0
        over the patches; without them the VLM runs on its text alone."""
        x = self._embed(batch["tokens"])
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
        with self._rules():
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
        with self._rules():
            return self._prefill(tokens, max_len, patch_embeds)

    def _prefill(self, tokens, max_len, patch_embeds):
        cfg = self.cfg
        batch = {"tokens": tokens, "labels": torch.zeros_like(tokens)}
        if patch_embeds is not None:
            batch["patch_embeds"] = patch_embeds
        x, positions, _, _ = self.embed_inputs(batch)
        b, s = x.shape[:2]
        max_len = max(max_len, s)
        states = []
        for i, (kind, is_moe) in enumerate(zip(self.kinds, self.moe_mask)):
            x, state = prefill_layer(self._tree(self.layers[i],
                                                f"layers.{i}."),
                                     x, cfg, kind, is_moe, positions)
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
        x = apply_norm(self._tree(self.final_norm, "final_norm."), x, cfg)
        return self._logits(x[:, -1:]), states

    # -- decode ----------------------------------------------------------------
    def init_decode_state(self, batch: int, max_len: int) -> list[dict]:
        with self._rules():
            return [init_layer_state(self.cfg, kind, batch, max_len,
                                     self.device) for kind in self.kinds]

    @torch.inference_mode()
    def decode_step(self, state: list[dict], tokens: torch.Tensor,
                    pos: int) -> tuple[torch.Tensor, list[dict]]:
        """tokens: (B, 1) at position ``pos`` -> (logits (B, 1, V),
        state); each attention layer's cache is written at ``pos`` in
        place, each recurrent layer's state replaced by its next."""
        cfg = self.cfg
        with self._rules():
            x = self._embed(tokens)
            for i in range(len(self.layers)):
                x, state[i] = decode_layer(
                    self._tree(self.layers[i], f"layers.{i}."), x, state[i],
                    cfg, self.kinds[i], self.moe_mask[i], int(pos))
            x = apply_norm(self._tree(self.final_norm, "final_norm."), x,
                           cfg)
            return self._logits(x), state
