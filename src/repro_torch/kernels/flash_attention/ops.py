"""Public wrapper: (B, T, H, hd) flash attention over the CUDA kernel.

Launch parameters (``block_q``/``block_k``/``block_threads``) resolve in
three tiers: hardcoded defaults < the tuned-store best config for this
shape/dtype/device (``tuned=``, see ``repro_torch.tune.kernels``) <
explicit keyword overrides.  The meta keys ``{bh, tq, tk, hd, causal}`` are
the reference's, so one shape description names a store record in both
packages.

Differentiable, as the reference's ``jax.custom_vjp`` is: when autograd
records (grad mode on and an input requiring grad), the call goes through
``FlashAttention``, a ``torch.autograd.Function`` whose forward runs the
forward kernel and saves ``q, k, v, o, lse`` and whose backward runs the
backward kernels (``flash_attention_bwd``).  Gradients reach the repeated
k/v heads; autograd sums them back through the caller's repeat.

Each build has its own launch points.  The bfloat16 forward's
(``DEFAULTS``) is the tuning space's default and what the store's records
replace, fitted to the head size (``fit_launch``: above hd 128 a warp
takes 16 query rows, not 32, so nemotron-4's hd 192 runs 256 threads); the float32 forward, the parity path, keeps ``F32_DEFAULTS``
(the space is the bfloat16 build's, and a float32 record is never
written).  The backward's are ``BWD_DEFAULTS`` (bfloat16) and
``BWD_F32_DEFAULTS``, as ``fit_bwd_launch`` cuts them to the card's
shared memory (bfloat16 at hd 192: 64 x 64): the reference reuses the
forward's blocks, but the backward programs own their rows differently
and there is no backward tuning space.  Other backward blocks are reached
through ``flash_attention_bwd``'s own keywords.
"""

from __future__ import annotations

import torch

from .. import resolve_launch_params
from .kernel import (BWD_LAUNCH, FWD_LAUNCH, MAX_HD_TWO_TILES,
                     MMA_MAX_THREADS, fit_bwd_launch, flash_attention_bwd,
                     flash_attention_fwd)

DEFAULTS = dict(FWD_LAUNCH[torch.bfloat16])
F32_DEFAULTS = dict(FWD_LAUNCH[torch.float32])
BWD_DEFAULTS = dict(BWD_LAUNCH[torch.bfloat16])
# 32 query rows: the dk/dv program's float32 tiles at hd 128 then take
# 183 KB of shared memory (64 x 64 would take all 227 KB a block can have)
BWD_F32_DEFAULTS = dict(BWD_LAUNCH[torch.float32])


def fit_launch(launch: dict, dtype: torch.dtype, hd: int) -> dict:
    """``launch`` made buildable at ``hd``: the bfloat16 forward gives a
    warp two tiles of 16 query rows (``block_threads == block_q``) only up
    to hd 128, whose accumulators then fill the registers; above, a warp
    takes one tile, so the threads double (the rows halve first where that
    would pass ``MMA_MAX_THREADS``).  Other launches are returned as they
    are."""
    p = dict(launch)
    if (dtype == torch.bfloat16 and hd > MAX_HD_TWO_TILES
            and p["block_threads"] == p["block_q"]):
        while 2 * p["block_q"] > MMA_MAX_THREADS:
            p["block_q"] //= 2
        p["block_threads"] = 2 * p["block_q"]
    return p


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) through the forward kernel; its backward
    through the backward kernels, from the saved ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int, fwd: dict):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     q_offset=q_offset, **fwd)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # do arrives as a view of the output projection's gradient
        launch = fit_bwd_launch(q.dtype, q.shape[-1])
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset, **launch)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    block_q: int | None = None, block_k: int | None = None,
                    block_threads: int | None = None,
                    stages: int | None = None,
                    tuned: bool | None = None) -> torch.Tensor:
    """q/k/v: (B, T, H, hd), kv already head-repeated -> (B, Tq, H, hd).

    The heads are folded into the kernel's grid through the views'
    strides, so any (B, T, H, hd) view with a contiguous last dimension
    goes in without a copy.  ``tuned=True`` resolves the cached best
    launch parameters for this (shape, dtype, device) with zero
    measurements (defaults on a miss); ``tuned=None`` does so only when
    tuning was enabled globally (``repro_torch.tune.kernels.configure``).
    """
    b, t, h, hd = q.shape
    meta = {"bh": b * h, "tq": t, "tk": k.shape[1], "hd": hd,
            "causal": bool(causal)}
    p = resolve_launch_params(
        "flash_attention", meta, q.dtype,
        defaults=DEFAULTS if q.dtype == torch.bfloat16 else F32_DEFAULTS,
        overrides={"block_q": block_q, "block_k": block_k,
                   "block_threads": block_threads, "stages": stages},
        tuned=tuned, device=q.device)
    p = fit_launch(p, q.dtype, hd)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, bool(causal), int(q_offset), p)
    out, _ = flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                 **p)
    return out
