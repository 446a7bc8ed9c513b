"""Layer assembly: (norm -> mixer -> residual) + (norm -> channel -> residual).

Mixer kinds: "attn" (GQA), "mamba" (selective SSM), "rwkv" (RWKV-6 time
mix).  The channel path is an MLP, an MoE layer (per the arch's interleave
mask), or the RWKV channel mix.  The reference groups a heterogeneous
stack (Jamba) into its smallest repeating pattern and scans over stacked
groups; the port keeps a flat list of layers (``LM.layers``), layer i
taking ``cfg.layer_kinds[i]`` and ``cfg.moe_layer_mask()[i]``.

Training (``apply_layer``) runs every mixer kind: the scans' gradients
come from their backward kernels through the ``torch.autograd.Function``s
of ``kernels/mamba_scan/ops.py`` and ``kernels/rwkv6_wkv/ops.py``.

Under ``remat="save_dots"`` (``apply_layer_saving``) a layer is cut into
segments under ``torch.utils.checkpoint`` whose boundaries are the
tensors the reference's policy saves by name (``save_only_these_names``):
``qkv_out`` (the attention's projections), ``mixer_out``, ``mlp_hidden``
(``x @ w_in``) and ``channel_out``.  A checkpointed segment keeps its
inputs and recomputes the rest in the backward pass, so a layer keeps its
input and those tensors only; the attention core (the flash-attention
kernel) is recomputed, as the reference recomputes it.  The recurrent
mixers, the RWKV channel mix and the MoE layer name only their outputs
(``mixer_out``, ``channel_out``), so each is one segment.  A SwiGLU
MLP also keeps its gate's product (``mlp_saving``).

Under ``seq_parallel`` rules over ranks (``apply_layer(seq=True)``) the
residual stream and the norms hold this rank's rows of the sequence: the
normed rows are all-gathered before the mixer and the channel, and each
keeps its rows of their (summed) outputs (``ComputeLayout.reduce``, inside
every mixer and channel).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import (attention_out, attention_qkv, decode_attention,
                        full_attention, init_attention, init_kv_cache,
                        kv_stripe)
from ..dist.api import current_rules, use_rules
from ..dist.sharding import compute_layout
from .config import ArchConfig
from .layers import (apply_mlp, apply_norm, finish, init_mlp, init_norm,
                     mlp_hidden, mlp_partial)
from .mamba import apply_mamba, decode_mamba, init_mamba, init_mamba_state
from .moe import apply_moe, init_moe
from .rwkv6 import (apply_rwkv_cmix, apply_rwkv_tmix, init_rwkv_cmix,
                    init_rwkv_state, init_rwkv_tmix)

__all__ = ["MIXERS", "apply_layer", "apply_layer_saving", "attention_saving",
           "decode_layer", "init_layer", "init_layer_state", "mlp_saving",
           "normed_sum", "prefill_layer", "segment"]

MIXERS = ("attn", "mamba", "rwkv")


def init_layer(gen, cfg: ArchConfig, kind: str, is_moe: bool,
               device) -> nn.ModuleDict:
    if kind not in MIXERS:
        raise ValueError(f"{cfg.name}: unknown mixer kind {kind!r}")
    mixer = {"attn": init_attention, "mamba": init_mamba,
             "rwkv": init_rwkv_tmix}[kind](gen, cfg, device)
    if kind == "rwkv":
        channel = init_rwkv_cmix(gen, cfg, device)
    elif is_moe:
        channel = init_moe(gen, cfg, device)
    else:
        channel = init_mlp(gen, cfg, device)
    return nn.ModuleDict({"norm1": init_norm(cfg, device),
                          "norm2": init_norm(cfg, device),
                          "mixer": mixer, "channel": channel})


def _channel(p, h: torch.Tensor, cfg: ArchConfig, kind: str, is_moe: bool,
             state: dict | None = None, return_state: bool = False,
             seq_dim: int | None = None):
    """The channel path: (out, aux loss, rwkv channel-mix state or None)."""
    if kind == "rwkv":
        out, cstate = apply_rwkv_cmix(p["channel"], h, cfg, state=state,
                                      return_state=return_state,
                                      seq_dim=seq_dim)
        return out, 0.0, cstate
    if is_moe:
        out, aux = apply_moe(p["channel"], h, cfg, seq_dim=seq_dim)
        return out, aux, None
    return apply_mlp(p["channel"], h, cfg, seq_dim=seq_dim), 0.0, None


def apply_layer(p, x: torch.Tensor, cfg: ArchConfig, kind: str, is_moe: bool,
                positions: torch.Tensor, seq: bool = False
                ) -> tuple[torch.Tensor, float]:
    """Training path. Returns (x, aux loss); only an MoE layer's aux is
    not 0.  With ``seq`` ``x`` holds this rank's rows of the sequence
    (``positions`` all of them; see the module docstring)."""
    cl = compute_layout() if seq else None
    seq_dim = None if cl is None else 1
    t = positions.shape[1]

    def whole(h):
        return h if cl is None else cl.gather_seq(h, 1, t)

    h = whole(apply_norm(p["norm1"], x, cfg))
    if kind == "attn":
        mixed = full_attention(p["mixer"], h, cfg, positions=positions,
                               causal=True, seq_dim=seq_dim)
    elif kind == "mamba":
        mixed = apply_mamba(p["mixer"], h, cfg, seq_dim=seq_dim)
    else:
        mixed = apply_rwkv_tmix(p["mixer"], h, cfg, seq_dim=seq_dim)[0]
    x = x + mixed
    h = whole(apply_norm(p["norm2"], x, cfg))
    ch, aux, _ = _channel(p, h, cfg, kind, is_moe, seq_dim=seq_dim)
    return x + ch, aux


def segment(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: ``args`` are kept
    and the rest is recomputed in the backward pass, under the rules
    active now (the backward runs outside the forward's)."""
    rules = current_rules()

    def run(*a):
        with use_rules(rules):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


def normed_sum(p, norm: str, parts: tuple, cfg: ArchConfig) -> torch.Tensor:
    """``apply_norm(p[norm], parts[0] + parts[1] + ..., cfg)``: a
    sublayer's normed input from the residual stream's parts, summed in
    the order the layer adds them."""
    x = parts[0]
    for y in parts[1:]:
        x = x + y
    return apply_norm(p[norm], x, cfg)


def attention_saving(p, normed, parts: tuple, cfg: ArchConfig, *,
                     positions: torch.Tensor, causal: bool,
                     kv_states: torch.Tensor | None = None,
                     seq_dim: int | None = None) -> torch.Tensor:
    """An attention sublayer under ``save_dots``: ``normed(*parts)``'s
    projections (the reference's ``qkv_out``; a cross-attention's keys
    and values from ``kv_states``) in one segment, the flash-attention
    kernel and the output projection in another."""
    if kv_states is None:
        q, k, v = segment(lambda *a: attention_qkv(
            p, normed(*a), cfg, positions=positions), *parts)
    else:
        q, k, v = segment(lambda enc, *a: attention_qkv(
            p, normed(*a), cfg, positions=positions, kv_states=enc),
            kv_states, *parts)
    return segment(lambda q, k, v: attention_out(
        p, q, k, v, cfg, causal=causal, seq_dim=seq_dim), q, k, v)


def mlp_saving(p, normed, parts: tuple, cfg: ArchConfig,
               seq_dim: int | None = None) -> torch.Tensor:
    """The MLP under ``save_dots``: ``normed(*parts)`` and the products
    that read it in one segment, which keeps ``mlp_hidden`` (and a
    SwiGLU's gate product), the rest in another.  The gate's product is
    kept beside ``mlp_hidden`` (the reference recomputes it): in a segment
    of its own it would recompute the norm, whose backward would then run
    twice, each time rounding to the compute dtype, and the gradients
    would drift from full remat's (~1 % at full width in bf16)."""
    swiglu = cfg.mlp_type == "swiglu"

    def products(*a):
        h = normed(*a)
        hid = mlp_hidden(p, h, cfg)
        return (hid, h @ p["w_gate"].to(hid.dtype)) if swiglu else (hid,)

    kept = segment(products, *parts)
    return segment(lambda *k: finish(*mlp_partial(
        p, None, cfg, hidden=k[0], gate=k[1] if swiglu else None), seq_dim),
        *kept)


def apply_layer_saving(p, x: torch.Tensor, cfg: ArchConfig, kind: str,
                       is_moe: bool, positions: torch.Tensor,
                       seq: bool = False) -> tuple[torch.Tensor, float]:
    """``apply_layer`` under ``remat="save_dots"`` (the module docstring):
    the same operations in the same order, in segments."""
    cl = compute_layout() if seq else None
    seq_dim = None if cl is None else 1
    t = positions.shape[1]

    def normed(norm: str, *parts):
        h = normed_sum(p, norm, parts, cfg)
        return h if cl is None else cl.gather_seq(h, 1, t)

    if kind == "attn":
        mixed = attention_saving(p["mixer"], lambda x: normed("norm1", x),
                                 (x,), cfg, positions=positions, causal=True,
                                 seq_dim=seq_dim)
    elif kind == "mamba":
        mixed = segment(lambda x: apply_mamba(
            p["mixer"], normed("norm1", x), cfg, seq_dim=seq_dim), x)
    else:
        mixed = segment(lambda x: apply_rwkv_tmix(
            p["mixer"], normed("norm1", x), cfg, seq_dim=seq_dim)[0], x)
    if kind == "rwkv" or is_moe:
        ch, aux = segment(lambda x, m: _channel(
            p, normed("norm2", x, m), cfg, kind, is_moe,
            seq_dim=seq_dim)[:2], x, mixed)
    else:
        ch, aux = mlp_saving(p["channel"], lambda *a: normed("norm2", *a),
                             (x, mixed), cfg, seq_dim), 0.0
    return x + mixed + ch, aux


def init_layer_state(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     device) -> dict:
    """A layer's zero decode state.  An attention layer's cache is this
    rank's stripe of ``max_len`` where the active rules shard the cache
    sequence (``attention.kv_stripe``); recurrent states are never
    sequence-sharded."""
    if kind == "attn":
        return init_kv_cache(cfg, batch, max_len, device,
                             stripe=kv_stripe(max_len))
    if kind == "mamba":
        return init_mamba_state(cfg, batch, device)
    return init_rwkv_state(cfg, batch, device)


def prefill_layer(p, x: torch.Tensor, cfg: ArchConfig, kind: str,
                  is_moe: bool, positions: torch.Tensor
                  ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also emits the layer's decode state: the
    prompt's keys and values (attention), the conv window and ssm state
    (mamba), or the shifted tokens and wkv state (rwkv)."""
    h = apply_norm(p["norm1"], x, cfg)
    if kind == "attn":
        mixed, state = full_attention(p["mixer"], h, cfg, positions=positions,
                                      causal=True, return_kv=True)
    elif kind == "mamba":
        mixed, state = apply_mamba(p["mixer"], h, cfg, return_state=True)
    else:
        mixed, state = apply_rwkv_tmix(p["mixer"], h, cfg, return_state=True)
    x = x + mixed
    h = apply_norm(p["norm2"], x, cfg)
    ch, _, cstate = _channel(p, h, cfg, kind, is_moe, return_state=True)
    if cstate is not None:
        state = {**state, **cstate}
    return x + ch, state


def decode_layer(p, x: torch.Tensor, state: dict, cfg: ArchConfig, kind: str,
                 is_moe: bool, pos: int) -> tuple[torch.Tensor, dict]:
    """Single-token decode path. x: (B, 1, D)."""
    h = apply_norm(p["norm1"], x, cfg)
    if kind == "attn":
        mixed, state = decode_attention(p["mixer"], h, state, cfg, pos=pos)
    elif kind == "mamba":
        mixed, state = decode_mamba(p["mixer"], h, state, cfg)
    else:
        mixed, tstate = apply_rwkv_tmix(p["mixer"], h, cfg, state=state)
        state = {**state, **tstate}
    x = x + mixed
    h = apply_norm(p["norm2"], x, cfg)
    ch, _, cstate = _channel(p, h, cfg, kind, is_moe, state=state)
    if cstate is not None:
        state = {**state, **cstate}
    return x + ch, state
