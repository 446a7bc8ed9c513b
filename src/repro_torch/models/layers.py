"""Shared building blocks: initializers, norms, RoPE, MLPs, embeddings.

The reference's parameter pytrees become ``nn.ParameterDict``s with the
same keys, so ``p["w_in"]`` reads alike in both packages and the
converter (``repro_torch.convert.lm_from_jax_params``) maps leaf to leaf.
Parameters live in ``cfg.param_dtype``; compute runs in
``cfg.compute_dtype``.  Every ``apply`` casts a weight with ``.to(dt)`` as
the reference casts with ``.astype(dt)``: once the model has been cast
for serving (``LM.cast_for_serving``) those casts are no-ops.

Parameters are trainable (``requires_grad``), the PyTorch idiom; serving
runs under ``torch.inference_mode()`` so that no graph is recorded.

Random initialisation draws from an explicit ``torch.Generator``; it gives
other numbers than ``jax.random`` from the same seed, so tests that compare
the packages carry the reference's weights across instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.sharding import ComputeLayout, compute_layout, region
from .config import ArchConfig

__all__ = ["apply_mlp", "apply_norm", "apply_rope", "dense_init",
           "embed_init", "embed_tokens", "group_norm", "init_embed",
           "init_mlp", "init_norm", "mlp_partial", "param", "rand_init",
           "rope_frequencies", "sinusoidal_positions", "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (config fields name dtypes)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


# -- initializers -------------------------------------------------------------

def dense_init(gen: torch.Generator | None, shape, dtype: str, device,
               in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in initializer (std = 1/sqrt(fan_in), cut at
    +-2 std).  On the ``meta`` device only the shape is made."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.device.type != "meta":
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out.mul_(shape[in_axis] ** -0.5)
    return out.to(torch_dtype(dtype))


def embed_init(gen: torch.Generator | None, shape, dtype: str,
               device) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.device.type != "meta":
        out.normal_(0.0, 0.02, generator=gen)
    return out.to(torch_dtype(dtype))


def rand_init(gen: torch.Generator | None, shape, dtype: str, device, *,
              uniform: bool, scale: float) -> torch.Tensor:
    """``scale`` times U[0, 1) (``uniform``) or N(0, 1) draws, in ``dtype``;
    on the ``meta`` device only the shape is made."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.device.type != "meta":
        if uniform:
            out.uniform_(0.0, 1.0, generator=gen)
        else:
            out.normal_(0.0, 1.0, generator=gen)
        out.mul_(scale)
    return out.to(torch_dtype(dtype))


# -- norms --------------------------------------------------------------------

def init_norm(cfg: ArchConfig, device,
              with_bias: bool | None = None) -> nn.ParameterDict:
    bias = cfg.norm_type == "layernorm" if with_bias is None else with_bias
    dt = torch_dtype(cfg.param_dtype)
    p = nn.ParameterDict({"scale": param(torch.ones(cfg.d_model, dtype=dt,
                                                    device=device))})
    if bias:
        p["bias"] = param(torch.zeros(cfg.d_model, dtype=dt, device=device))
    return p


def apply_norm(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    if cfg.norm_type == "rmsnorm" and "bias" not in p:
        inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True)
                          + cfg.norm_eps)
        out = x32 * inv * p["scale"].float()
    else:
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float()
        if "bias" in p:
            out = out + p["bias"].float()
    return out.to(dt)


def group_norm(x: torch.Tensor, n_groups: int,
               eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm over the last dim, no affine (RWKV's per-head wkv
    normalisation), in float32; returns x's dtype."""
    dt = x.dtype
    shape = x.shape
    x32 = x.float().reshape(*shape[:-1], n_groups, -1)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return out.reshape(shape).to(dt)


# -- rotary embeddings ----------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T).  The
    split-halves form, angles in float32."""
    dt = x.dtype
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (..., T, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                    # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def sinusoidal_positions(n_pos: int, d_model: int,
                         device=None) -> torch.Tensor:
    """(n_pos, d_model) float32: the sines of ``pos / 10000^(2i/d)`` in
    the first half, their cosines in the second (the encoder-decoder's
    positions on both streams)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    angle = pos / (10_000.0 ** (2 * dim / d_model))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# -- MLPs --------------------------------------------------------------------

def init_mlp(gen, cfg: ArchConfig, device,
             d_ff: int | None = None) -> nn.ParameterDict:
    d_ff = d_ff or cfg.d_ff
    d, dt = cfg.d_model, cfg.param_dtype
    p = nn.ParameterDict({"w_in": param(dense_init(gen, (d, d_ff), dt, device)),
                          "w_out": param(dense_init(gen, (d_ff, d), dt, device))})
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = param(dense_init(gen, (d, d_ff), dt, device))
    return p


def mlp_region(leaf: str, shape, cl: ComputeLayout) -> tuple:
    """The compute region of an MLP's leaf: this rank's ``ff`` columns."""
    if leaf in ("w_in", "w_gate"):
        return region(shape, 1, cl.ff(shape[1]), cl.ff_split)
    if leaf == "w_out":
        return region(shape, 0, cl.ff(shape[0]), cl.ff_split)
    return region(shape)


def mlp_partial(p, x: torch.Tensor, cfg: ArchConfig, d_ff: int | None = None
                ) -> tuple[torch.Tensor, tuple]:
    """The MLP on this rank's ``ff`` columns of a ``d_ff``-wide MLP
    (default ``cfg.d_ff``): (output, the mesh axes its ranks' outputs are
    still to be summed over; ``()`` where the columns are not split)."""
    dt = torch_dtype(cfg.compute_dtype)
    x = x.to(dt)
    h = x @ p["w_in"].to(dt)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * h
    elif cfg.mlp_type == "squared_relu":
        h = F.relu(h).square()
    elif cfg.mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_type)
    out = h @ p["w_out"].to(dt)
    cl = compute_layout()
    split = cl is not None and cl.ff(d_ff or cfg.d_ff) is not None
    return out, cl.ff_split.axes if split else ()


def finish(y: torch.Tensor, partial: tuple,
           seq_dim: int | None = None) -> torch.Tensor:
    """A sublayer's output summed over the ranks of the mesh axes
    ``partial`` (with ``seq_dim``, this rank's rows of the sum:
    ``seq_parallel``); ``y`` itself where no rules split anything."""
    cl = compute_layout()
    return y if cl is None else cl.reduce(y, partial, seq_dim)


def apply_mlp(p, x: torch.Tensor, cfg: ArchConfig, *,
              d_ff: int | None = None,
              seq_dim: int | None = None) -> torch.Tensor:
    """The MLP; under a mesh of ranks each computes its ``ff`` columns and
    the outputs are summed over the model axes (with ``seq_dim``, each
    rank keeps its rows of the sum: ``seq_parallel``)."""
    return finish(*mlp_partial(p, x, cfg, d_ff), seq_dim)


# -- embeddings & heads ---------------------------------------------------------

def init_embed(gen, cfg: ArchConfig, device) -> nn.ParameterDict:
    p = nn.ParameterDict({"tokens": param(embed_init(
        gen, (cfg.vocab_size, cfg.d_model), cfg.param_dtype, device))})
    if not cfg.tie_embeddings:
        p["lm_head"] = param(dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                        cfg.param_dtype, device))
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings.  Under a mesh of ranks that splits the vocabulary
    ``p["tokens"]`` is this rank's slice of it: each rank looks up the
    tokens it holds (zeros for the others) and the ranks' rows are
    summed."""
    dt = torch_dtype(cfg.compute_dtype)
    cl = compute_layout()
    vocab = None if cl is None else cl.vocab(cfg.vocab_size)
    if vocab is None:
        # gather, then cast: the reference's cast-then-take, without
        # casting the rows no token uses
        return p["tokens"][tokens].to(dt)
    local = tokens - vocab.start
    held = (local >= 0) & (local < vocab.stop - vocab.start)
    out = p["tokens"][torch.where(held, local, 0)].to(dt)
    out = out * held[..., None].to(dt)
    return cl.reduce(out, cl.vocab_split.axes)
