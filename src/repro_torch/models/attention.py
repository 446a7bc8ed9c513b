"""Grouped-query attention: prefill through the flash-attention kernel and
single-token decode through the split-KV decode kernel, with a KV cache.

The reference has two paths: XLA (``blockwise_attention``, the
distribution path) and ``attn_impl="pallas"`` (the TPU kernels).  The port
has one: the CUDA kernels of ``repro_torch.kernels``, whose plain PyTorch
versions run for tensors on the CPU.  ``attn_impl`` keeps its field;
``"auto"`` and ``"pallas"`` both mean the kernels and ``"xla"`` is refused.

Cross-attention (the encoder-decoder's decoder) takes its keys and values
from the encoder stream, with no RoPE on either side: ``full_attention``
with ``kv_states`` runs the flash-attention kernel unmasked over
``Tq != Tk``, and ``decode_attention(cross=True)`` reads the precomputed
encoder cache (``precompute_cross_kv``) whole through the decode kernel,
writing nothing.

Sequence-sharded decode (``dist.seq_decode``): when the active rules map
``"kv_seq"`` to mesh axes of ranks whose count divides the **global** cache
length, ``init_kv_cache(stripe=kv_stripe(...))`` allocates only this
rank's stripe of the positions and marks the cache with its ``Stripe``;
a self-attention decode of a marked cache goes through
``seq_decode_attention`` (B4 over the stripe, a logsumexp combine across
ranks), cross-attention never.  The decision is taken where the cache is
allocated, from the global length: at the decode site the cache is
already local.  Otherwise the dense path runs, as the reference falls
back.  The reference's ``constrain`` sharding hints place nothing in the
port (each rank holds its own part) and are dropped.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..dist.api import current_rules
from ..dist.ranks import RankMesh
from ..kernels.decode_attention import ops as da_ops
from ..kernels.flash_attention import ops as fa_ops
from .config import ArchConfig
from .layers import apply_rope, dense_init, param, torch_dtype

__all__ = ["NEG_INF", "Stripe", "decode_attention", "full_attention",
           "init_attention", "init_kv_cache", "kv_stripe",
           "precompute_cross_kv"]

NEG_INF = -1e30


def _check_impl(cfg: ArchConfig) -> None:
    if cfg.attn_impl not in ("auto", "pallas"):
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r}: the port has no XLA path; its "
            "attention is the CUDA kernels ('auto' or 'pallas'), and their "
            "plain PyTorch versions (flash_attention_fwd_plain, "
            "decode_attention_plain) run for tensors on the CPU")


def init_attention(gen, cfg: ArchConfig, device,
                   cross: bool = False) -> nn.ParameterDict:
    """q/k/v/o projections, and q/k/v biases where ``cfg.qkv_bias`` asks
    for them, except in a ``cross`` block."""
    d, hd, dt = cfg.d_model, cfg.head_dim, cfg.param_dtype
    p = nn.ParameterDict({
        "wq": param(dense_init(gen, (d, cfg.n_heads, hd), dt, device)),
        "wk": param(dense_init(gen, (d, cfg.n_kv_heads, hd), dt, device)),
        "wv": param(dense_init(gen, (d, cfg.n_kv_heads, hd), dt, device)),
        "wo": param(dense_init(gen, (cfg.n_heads, hd, d), dt, device,
                               in_axis=0)),
    })
    if cfg.qkv_bias and not cross:
        pdt = torch_dtype(dt)
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = param(torch.zeros((n, hd), dtype=pdt, device=device))
    return p


def _project(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """"btd,dnh->btnh" as one matrix product."""
    b, t, d = x.shape
    return (x.to(dt) @ w.to(dt).reshape(d, -1)).view(b, t, *w.shape[1:])


def _project_q(p, x, cfg: ArchConfig, positions) -> torch.Tensor:
    dt = torch_dtype(cfg.compute_dtype)
    q = _project(x, p["wq"], dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
    if positions is not None and cfg.positions == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(p, x, cfg: ArchConfig, positions):
    dt = torch_dtype(cfg.compute_dtype)
    k = _project(x, p["wk"], dt)
    v = _project(x, p["wv"], dt)
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if positions is not None and cfg.positions == "rope":
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,T,KV,hd) -> (B,T,H,hd) by repeating each kv head H/KV times."""
    b, t, kv, hd = k.shape
    if kv == n_heads:
        return k
    rep = n_heads // kv
    return k[:, :, :, None, :].expand(b, t, kv, rep, hd).reshape(
        b, t, n_heads, hd)


def _out_proj(p, out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """"btnh,nhd->btd" as one matrix product."""
    dt = torch_dtype(cfg.compute_dtype)
    b, t = out.shape[:2]
    wo = p["wo"].to(dt)
    return out.to(dt).reshape(b, t, -1) @ wo.reshape(-1, wo.shape[-1])


def full_attention(p, x: torch.Tensor, cfg: ArchConfig, *,
                   positions: torch.Tensor, causal: bool = True,
                   kv_states: torch.Tensor | None = None,
                   kv_positions: torch.Tensor | None = None,
                   return_kv: bool = False):
    """Training / prefill attention over full sequences through the
    flash-attention kernel.

    ``kv_states`` switches to cross-attention: the keys and values come
    from that stream (B, Tk, D), and neither side gets RoPE.
    ``kv_positions`` are the keys' RoPE positions in self-attention
    (default ``positions``).  ``return_kv`` also returns the (pre-repeat)
    keys/values for cache fills."""
    _check_impl(cfg)
    cross = kv_states is not None
    q = _project_q(p, x, cfg, None if cross else positions)
    if kv_positions is None:
        kv_positions = positions
    k, v = _project_kv(p, kv_states if cross else x, cfg,
                       None if cross else kv_positions)
    # tuned=None: resolves the cached best launch params when kernel
    # tuning is enabled (repro_torch.tune.kernels.configure; serve.py's
    # --tuned-kernels), hardcoded defaults otherwise
    out = fa_ops.flash_attention(q, _repeat_kv(k, cfg.n_heads),
                                 _repeat_kv(v, cfg.n_heads), causal=causal,
                                 tuned=None)
    res = _out_proj(p, out, cfg)
    if return_kv:
        return res, {"k": k, "v": v}
    return res


# -- decode -------------------------------------------------------------------

@dataclass(frozen=True)
class Stripe:
    """This rank's stripe of a sequence-sharded KV cache: positions
    ``[s0, s0 + length)``, along ``seq_axes`` of ``mesh`` (a
    ``dist.ranks.RankMesh``)."""

    mesh: object
    seq_axes: tuple
    batch_axes: tuple
    s0: int
    length: int


def kv_stripe(max_len: int) -> Stripe | None:
    """The stripe the active rules give a self-attention cache of
    ``max_len`` global positions, or ``None`` for a whole cache: no rules,
    no ``"kv_seq"`` axes, a mesh with no ranks behind it (a
    ``ShapeMesh``: its layouts are derived, never run), or a shard count
    that does not divide ``max_len`` (the reference's fallback)."""
    rules = current_rules()
    if rules is None or not isinstance(rules.mesh, RankMesh):
        return None
    seq = rules.axes("kv_seq")
    n = rules.axes_size(seq)
    if n <= 1 or max_len % n:
        return None
    length = max_len // n
    return Stripe(mesh=rules.mesh, seq_axes=seq,
                  batch_axes=rules.axes("batch"),
                  s0=rules.mesh.index(seq) * length, length=length)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                  dtype=None, stripe: Stripe | None = None) -> dict:
    """A zero cache (batch, max_len, KV, hd); with ``stripe`` only its
    ``stripe.length`` positions, the cache marked ``"stripe"``."""
    dt = dtype or torch_dtype(cfg.compute_dtype)
    length = max_len if stripe is None else stripe.length
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if stripe is not None:
        cache["stripe"] = stripe
    return cache


def decode_attention(p, x: torch.Tensor, cache: dict, cfg: ArchConfig, *,
                     pos: int, cross: bool = False
                     ) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D); cache k/v: (B, S, KV, hd).

    ``pos`` is the current position: the new KV is written into the cache
    at ``pos`` in place (the reference returns an updated copy and donates
    the old one) and attention spans positions <= pos.  With ``cross`` the
    cache holds the encoder's keys and values (``precompute_cross_kv``):
    nothing is written, no RoPE is applied, and every position is read.
    A self-attention cache marked with a ``Stripe`` holds this rank's
    positions only, and the step runs ``dist.seq_decode``.
    """
    _check_impl(cfg)
    b = x.shape[0]
    positions = None if cross else torch.full((b, 1), pos, device=x.device)
    q = _project_q(p, x, cfg, positions)
    dt = torch_dtype(cfg.compute_dtype)
    stripe = None if cross else cache.get("stripe")
    if stripe is not None:
        from ..dist.seq_decode import seq_decode_attention
        k_new, v_new = _project_kv(p, x, cfg, positions)
        out, _, _ = seq_decode_attention(
            q[:, 0], k_new[:, 0], v_new[:, 0], cache["k"], cache["v"], pos,
            mesh=stripe.mesh, seq_axes=stripe.seq_axes,
            batch_axes=stripe.batch_axes)
        return _out_proj(p, out.to(dt)[:, None], cfg), cache
    if not cross:
        k_new, v_new = _project_kv(p, x, cfg, positions)
        cache["k"][:, pos] = k_new[:, 0]
        cache["v"][:, pos] = v_new[:, 0]
    out = da_ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                  length=None if cross else pos + 1,
                                  tuned=None)
    return _out_proj(p, out.to(dt)[:, None], cfg), cache


def precompute_cross_kv(p, enc: torch.Tensor, cfg: ArchConfig) -> dict:
    """The cross-attention cache of one decoder layer: the encoder
    states' keys and values (B, S_enc, KV, hd), without RoPE."""
    k, v = _project_kv(p, enc, cfg, None)
    return {"k": k, "v": v}
