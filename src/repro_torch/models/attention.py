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
back.

Tensor parallelism (``dist.sharding.compute_layout``): where the rules
split the heads over ranks, each rank projects its q heads and the kv
heads they read (all kv heads where ``kv_shard`` is not ``"heads"``: the
reference's replicated ``kv_heads``), runs B3/B4/B5 on them, so each kv
head keeps its ``rep`` q heads (fewer where a rank holds fewer), and the
output projections of the ranks are summed (the reference's
``constrain(res, "batch", "seq", None)``; with ``seq_dim`` each rank keeps
its rows of the sum).  A decode cache holds the kv heads the rank
projects; where it holds all of them the rank's q heads are placed among
zeros for the other heads, so B4 reads the cache whole.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..dist.api import current_rules
from ..dist.ranks import RankMesh
from ..dist.sharding import ComputeLayout, compute_layout, region
from ..kernels.decode_attention import ops as da_ops
from ..kernels.flash_attention import ops as fa_ops
from .config import ArchConfig
from .layers import apply_rope, dense_init, param, torch_dtype

__all__ = ["NEG_INF", "Stripe", "attention_out", "attention_qkv",
           "attention_region", "decode_attention", "full_attention",
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


def attention_region(leaf: str, shape, cfg: ArchConfig,
                     cl: ComputeLayout) -> tuple:
    """The compute region of an attention block's leaf (self- or
    cross-attention): the q heads and the output projection's rows of
    this rank's heads, the kv projections of the kv heads it computes."""
    if leaf in ("wq", "bq", "wo"):
        return region(shape, 1 if leaf == "wq" else 0,
                      cl.heads(cfg.n_heads), cl.model)
    if leaf in ("wk", "wv", "bk", "bv"):
        kv = cl.kv_computed(cfg.n_heads, cfg.n_kv_heads)
        return region(shape, 1 if leaf[0] == "w" else 0, kv, cl.model,
                      cl.model.range(cfg.n_kv_heads) == kv)
    return region(shape)


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


def _read_kv(k: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The kv heads this rank's q heads read, of ``k`` (B, T, KV', hd):
    ``k`` itself where it holds just those."""
    cl = compute_layout()
    read = None if cl is None else cl.kv_heads(cfg.n_heads, cfg.n_kv_heads)
    if read is None or k.shape[2] == read.stop - read.start:
        return k
    return k[:, :, read]


def _reduce_heads(res: torch.Tensor, cfg: ArchConfig,
                  seq_dim: int | None = None) -> torch.Tensor:
    """The output projection summed over the ranks' heads."""
    cl = compute_layout()
    if cl is None:
        return res
    split = cl.heads(cfg.n_heads) is not None
    return cl.reduce(res, cl.model.axes if split else (), seq_dim)


def _out_proj(p, out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """"btnh,nhd->btd" as one matrix product."""
    dt = torch_dtype(cfg.compute_dtype)
    b, t = out.shape[:2]
    wo = p["wo"].to(dt)
    return out.to(dt).reshape(b, t, -1) @ wo.reshape(-1, wo.shape[-1])


def attention_qkv(p, x: torch.Tensor, cfg: ArchConfig, *,
                  positions: torch.Tensor,
                  kv_states: torch.Tensor | None = None,
                  kv_positions: torch.Tensor | None = None):
    """The projections ``(q, k, v)``, RoPE applied: the reference's
    ``qkv_out`` (``kv_states``, ``kv_positions``: ``full_attention``'s)."""
    _check_impl(cfg)
    cross = kv_states is not None
    q = _project_q(p, x, cfg, None if cross else positions)
    if kv_positions is None:
        kv_positions = positions
    k, v = _project_kv(p, kv_states if cross else x, cfg,
                       None if cross else kv_positions)
    return q, k, v


def attention_out(p, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ArchConfig, *, causal: bool = True,
                  seq_dim: int | None = None) -> torch.Tensor:
    """The flash-attention kernel over ``attention_qkv``'s projections,
    then the output projection (summed over the ranks' heads)."""
    # tuned=None: resolves the cached best launch params when kernel
    # tuning is enabled (repro_torch.tune.kernels.configure; serve.py's
    # --tuned-kernels), hardcoded defaults otherwise
    kr, vr = _read_kv(k, cfg), _read_kv(v, cfg)
    n_heads = q.shape[2]
    out = fa_ops.flash_attention(q, _repeat_kv(kr, n_heads),
                                 _repeat_kv(vr, n_heads), causal=causal,
                                 tuned=None)
    return _reduce_heads(_out_proj(p, out, cfg), cfg, seq_dim)


def full_attention(p, x: torch.Tensor, cfg: ArchConfig, *,
                   positions: torch.Tensor, causal: bool = True,
                   kv_states: torch.Tensor | None = None,
                   kv_positions: torch.Tensor | None = None,
                   return_kv: bool = False, seq_dim: int | None = None):
    """Training / prefill attention over full sequences through the
    flash-attention kernel: ``attention_qkv``, then ``attention_out``.

    ``kv_states`` switches to cross-attention: the keys and values come
    from that stream (B, Tk, D), and neither side gets RoPE.
    ``kv_positions`` are the keys' RoPE positions in self-attention
    (default ``positions``).  ``return_kv`` also returns the (pre-repeat)
    keys/values for cache fills.  Under a mesh of ranks ``p`` holds this
    rank's heads (``seq_dim``: see the module docstring)."""
    q, k, v = attention_qkv(p, x, cfg, positions=positions,
                            kv_states=kv_states, kv_positions=kv_positions)
    res = attention_out(p, q, k, v, cfg, causal=causal, seq_dim=seq_dim)
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
    ``stripe.length`` positions, the cache marked ``"stripe"``.  Under a
    mesh of ranks ``KV`` is the kv heads the rank projects."""
    dt = dtype or torch_dtype(cfg.compute_dtype)
    length = max_len if stripe is None else stripe.length
    cl = compute_layout()
    kv = None if cl is None else cl.kv_computed(cfg.n_heads, cfg.n_kv_heads)
    n_kv = cfg.n_kv_heads if kv is None else kv.stop - kv.start
    shape = (batch, length, n_kv, cfg.head_dim)
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
    q, heads = _q_over_cache(q[:, 0], cache["k"].shape[2], cfg)
    if stripe is not None:
        from ..dist.seq_decode import seq_decode_attention
        k_new, v_new = _project_kv(p, x, cfg, positions)
        out, _, _ = seq_decode_attention(
            q, k_new[:, 0], v_new[:, 0], cache["k"], cache["v"], pos,
            mesh=stripe.mesh, seq_axes=stripe.seq_axes,
            batch_axes=stripe.batch_axes)
    else:
        if not cross:
            k_new, v_new = _project_kv(p, x, cfg, positions)
            cache["k"][:, pos] = k_new[:, 0]
            cache["v"][:, pos] = v_new[:, 0]
        out = da_ops.decode_attention(q, cache["k"], cache["v"],
                                      length=None if cross else pos + 1,
                                      tuned=None)
    if heads is not None:
        out = out[:, heads]
    res = _out_proj(p, out.to(dt)[:, None], cfg)
    return _reduce_heads(res, cfg), cache


def _q_over_cache(q: torch.Tensor, cache_kv: int, cfg: ArchConfig):
    """(q, heads): where this rank's q heads (B, H', hd) read only some of
    the ``cache_kv`` kv heads the cache holds, q placed at its heads among
    zeros for the other q heads of those kv heads, and the slice of its
    heads in the result (else ``q`` and ``None``)."""
    cl = compute_layout()
    mine = None if cl is None else cl.heads(cfg.n_heads)
    read = None if cl is None else cl.kv_heads(cfg.n_heads, cfg.n_kv_heads)
    if mine is None or cache_kv == read.stop - read.start:
        return q, None
    full = q.new_zeros((q.shape[0], cfg.n_heads, q.shape[2]))
    full[:, mine] = q
    return full, mine


def precompute_cross_kv(p, enc: torch.Tensor, cfg: ArchConfig) -> dict:
    """The cross-attention cache of one decoder layer: the encoder
    states' keys and values (B, S_enc, KV, hd), without RoPE."""
    k, v = _project_kv(p, enc, cfg, None)
    return {"k": k, "v": v}
