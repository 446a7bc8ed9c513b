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

Not ported yet: the sequence-sharded decode branch (``dist.seq_decode``).
The reference's ``constrain`` sharding hints have no effect on one card
and are dropped.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.decode_attention import ops as da_ops
from ..kernels.flash_attention import ops as fa_ops
from .config import ArchConfig
from .layers import apply_rope, dense_init, param, torch_dtype

__all__ = ["NEG_INF", "decode_attention", "full_attention",
           "init_attention", "init_kv_cache", "precompute_cross_kv"]

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

def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                  dtype=None) -> dict:
    dt = dtype or torch_dtype(cfg.compute_dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(p, x: torch.Tensor, cache: dict, cfg: ArchConfig, *,
                     pos: int, cross: bool = False
                     ) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D); cache k/v: (B, S, KV, hd).

    ``pos`` is the current position: the new KV is written into the cache
    at ``pos`` in place (the reference returns an updated copy and donates
    the old one) and attention spans positions <= pos.  With ``cross`` the
    cache holds the encoder's keys and values (``precompute_cross_kv``):
    nothing is written, no RoPE is applied, and every position is read.
    """
    _check_impl(cfg)
    b = x.shape[0]
    positions = None if cross else torch.full((b, 1), pos, device=x.device)
    q = _project_q(p, x, cfg, positions)
    if not cross:
        k_new, v_new = _project_kv(p, x, cfg, positions)
        cache["k"][:, pos] = k_new[:, 0]
        cache["v"][:, pos] = v_new[:, 0]
    out = da_ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                  length=None if cross else pos + 1,
                                  tuned=None)
    dt = torch_dtype(cfg.compute_dtype)
    return _out_proj(p, out.to(dt)[:, None], cfg), cache


def precompute_cross_kv(p, enc: torch.Tensor, cfg: ArchConfig) -> dict:
    """The cross-attention cache of one decoder layer: the encoder
    states' keys and values (B, S_enc, KV, hd), without RoPE."""
    k, v = _project_kv(p, enc, cfg, None)
    return {"k": k, "v": v}
